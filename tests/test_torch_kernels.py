"""Kernel parity: each port kernel's plain version against ``repro``'s Pallas
kernel (interpret mode on the CPU), and each CUDA kernel against its plain
version on the card (tests/test_torch_kernels_cuda.py).

K1 ``gather_rows_dist`` and K2 ``gather_rows_dist_q8`` (both metrics), K3
``twotower_score``.  ``repro``'s K1/K2 score one query per call; the port's
take a batch, so the reference is called once per query row.

Tolerances: invalid slots are exactly 3.4e38 (as float32).  Valid slots
agree within rtol=1e-6, atol=1e-6: the frameworks sum the d products in
different orders (fp32 rounding).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # CI container has no hypothesis; run fixed examples
    from _hypothesis_fallback import given, settings, st

from repro.kernels import ops as j_ops
from repro.kernels.gather_dist import gather_rows_dist as j_rows
from repro.kernels.gather_dist import gather_rows_dist_q8 as j_rows_q8
from repro.kernels.twotower_score import twotower_score as j_twotower
from repro.quant import quantize_db as j_quantize

from repro_torch.kernels import (
    gather_rows_dist,
    gather_rows_dist_q8,
    launch_counts,
    reset_launch_counts,
    twotower_score,
)
from repro_torch.kernels import ref
from repro_torch.quant import quantize_db

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

from test_torch_kernels_cuda import _assert_masked, _inputs

@settings(deadline=None, max_examples=6)
@given(R=st.integers(min_value=1, max_value=11),
       d=st.integers(min_value=3, max_value=41))
def test_gather_rows_dist_plain_matches_pallas(R, d):
    """K1, both metrics, odd R and d, -1 ids."""
    db, q, qn, ids, inv = _inputs(3, R, d, seed=100 * R + d)
    t = torch.from_numpy
    got_l2 = gather_rows_dist(t(ids), t(db), t(q))
    got_cos = gather_rows_dist(t(ids), t(db), t(qn), t(inv))
    for b in range(ids.shape[0]):
        want_l2 = j_rows(jnp.asarray(ids[b]), jnp.asarray(db),
                         jnp.asarray(q[b]), interpret=True)
        want_cos = j_rows(jnp.asarray(ids[b]), jnp.asarray(db),
                          jnp.asarray(qn[b]), jnp.asarray(inv), interpret=True)
        _assert_masked(got_l2[b], want_l2, ids[b], 1e-6, 1e-6)
        _assert_masked(got_cos[b], want_cos, ids[b], 1e-6, 1e-6)


@settings(deadline=None, max_examples=6)
@given(R=st.integers(min_value=1, max_value=11),
       d=st.integers(min_value=3, max_value=141))
def test_gather_rows_dist_q8_plain_matches_pallas(R, d):
    """K2, both metrics, odd R and d (one and two 128-dim blocks), -1 ids."""
    db, q, qn, ids, _ = _inputs(3, R, d, seed=100 * R + d + 1)
    qdb = quantize_db(db)
    jq = j_quantize(db)
    dp = qdb.codes.shape[1]
    pad = lambda x: np.pad(x, ((0, 0), (0, dp - d)))  # noqa: E731
    t = torch.from_numpy
    got_l2 = gather_rows_dist_q8(t(ids), t(qdb.codes), t(qdb.scale),
                                 t(qdb.zero), t(pad(q)))
    got_cos = gather_rows_dist_q8(t(ids), t(qdb.codes), t(qdb.scale),
                                  t(qdb.zero), t(pad(qn)), t(qdb.inv_norms))
    for b in range(ids.shape[0]):
        args = (jnp.asarray(ids[b]), jnp.asarray(jq.codes),
                jnp.asarray(jq.scale), jnp.asarray(jq.zero))
        want_l2 = j_rows_q8(*args, jnp.asarray(pad(q)[b]), interpret=True)
        want_cos = j_rows_q8(*args, jnp.asarray(pad(qn)[b]),
                             jnp.asarray(jq.inv_norms), interpret=True)
        _assert_masked(got_l2[b], want_l2, ids[b], 1e-6, 1e-6)
        _assert_masked(got_cos[b], want_cos, ids[b], 1e-6, 1e-6)


@pytest.mark.parametrize("B,H,d", [(5, 3, 7), (70, 64, 128), (129, 130, 33)])
def test_twotower_score_plain_matches_pallas_and_ref(B, H, d):
    """K3 against the TPU kernel (interpret) and against ``repro``'s
    ``ops.twotower_score`` (its ``ref.py`` path on the CPU)."""
    rng = np.random.default_rng(B + H + d)
    q = rng.standard_normal((B, d)).astype(np.float32)
    h = rng.standard_normal((H, d)).astype(np.float32)
    got = twotower_score(torch.from_numpy(q), torch.from_numpy(h)).numpy()
    kern = np.asarray(j_twotower(jnp.asarray(q), jnp.asarray(h), interpret=True))
    refv = np.asarray(j_ops.twotower_score(jnp.asarray(q), jnp.asarray(h)))
    np.testing.assert_allclose(got, kern, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, refv, rtol=1e-6, atol=1e-6)


def test_wrappers_reject_what_the_kernels_do_not_take():
    db, q, _, ids, inv = _inputs(2, 4, 8)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="int32"):
        gather_rows_dist(t(ids).long(), t(db), t(q))
    with pytest.raises(ValueError, match="q must be"):
        gather_rows_dist(t(ids), t(db), t(q[:1]))
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows_dist(t(ids), t(db).T.contiguous().T, t(q))
    with pytest.raises(ValueError, match="inv_norms"):
        gather_rows_dist(t(ids), t(db), t(q), t(inv[:3]))
    qdb = quantize_db(db)
    with pytest.raises(ValueError, match="int8"):
        gather_rows_dist_q8(t(ids), t(qdb.codes).float(), t(qdb.scale),
                            t(qdb.zero), torch.zeros(2, 128))
    with pytest.raises(ValueError, match="twotower_score"):
        twotower_score(t(q), t(db[:, :5]))


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    db, q, _, ids, _ = _inputs(2, 4, 8)
    t = torch.from_numpy
    reset_launch_counts()
    out = gather_rows_dist(t(ids), t(db), t(q))
    assert torch.equal(out, ref.gather_rows_dist_ref(t(ids), t(db), t(q)))
    assert launch_counts() == {"gather_rows_dist": 0, "gather_rows_dist_q8": 0,
                               "twotower_score": 0, "topk_min": 0,
                               "l2dist": 0, "gather_dist": 0,
                               "greedy_assign": 0}
