"""``repro_torch.quant`` is bit-equal to ``repro.quant``: codes, scales,
zeros and inverse norms, odd d and offset (all-positive) blocks included."""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # CI container has no hypothesis; run fixed examples
    from _hypothesis_fallback import given, settings, st

from repro import quant as jq
from repro_torch import quant as tq


def _assert_bit_equal(db, block=tq.BLOCK):
    a = jq.quantize_db(db, block=block)
    b = tq.quantize_db(db, block=block)
    for f in ("codes", "scale", "zero", "inv_norms"):
        x, y = np.asarray(getattr(a, f)), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), f
    assert (b.block, b.n_blocks) == (a.block, a.n_blocks)
    assert tq.memory_bytes(b) == jq.memory_bytes(a)
    return b


@settings(deadline=None, max_examples=6)
@given(n=st.integers(min_value=1, max_value=40),
       d=st.integers(min_value=1, max_value=300))
def test_quantize_bit_equal(n, d):
    rng = np.random.default_rng(n * 1000 + d)
    _assert_bit_equal((5.0 * rng.standard_normal((n, d))).astype(np.float32))


@pytest.mark.parametrize("off", [10.5, -7.25, 200.0])
def test_quantize_offset_blocks_bit_equal(off):
    rng = np.random.default_rng(42)
    db = (off + 0.1 * rng.standard_normal((20, 37))).astype(np.float32)
    b = _assert_bit_equal(db)
    deq = tq.dequantize(b)
    assert np.array_equal(deq[:, 37:], np.zeros_like(deq[:, 37:]))


def test_quantize_other_block_and_dequantize_tensor():
    rng = np.random.default_rng(3)
    db = rng.standard_normal((16, 70)).astype(np.float32)
    b = _assert_bit_equal(db, block=32)
    want = tq.dequantize(b, d=70)
    got = tq.dequantize(b.to("cpu"), d=70)
    assert isinstance(got, torch.Tensor)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, np.asarray(jq.dequantize(jq.quantize_db(db, 32), 70)))


@pytest.mark.parametrize("d,block", [(37, 128), (300, 128), (64, 32)])
def test_quant_config_equals_reference(d, block):
    db = np.random.default_rng(d).standard_normal((12, d)).astype(np.float32)
    want = jq.quant_config(jq.quantize_db(db, block=block))
    assert tq.quant_config(tq.quantize_db(db, block=block)) == want
    # the schema fragment does not depend on where the codebook lives
    assert tq.quant_config(tq.quantize_db(db, block=block).to("cpu")) == want
