"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: skipped without a CUDA card (the kernels are built with
nvcc for sm_90a and have no CPU mode).  Imports neither ``jax`` nor
``repro``, so it runs on a machine with only PyTorch:

    python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances: invalid slots exactly 3.4e38; valid values within rtol=1e-5,
atol=1e-5 (the kernels split each sum over 32 lanes and use FMAs).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    gather_rows_dist,
    gather_rows_dist_q8,
    launch_counts,
    twotower_score,
)
from repro_torch.kernels import ref
from repro_torch.quant import quantize_db

INF32 = np.float32(3.4e38)


def _inputs(B, R, d, n=64, seed=0):
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    ids = rng.integers(0, n, (B, R)).astype(np.int32)
    ids[:, ::3] = -1
    ids[rng.random((B, R)) < 0.2] = -1
    inv = (1.0 / np.maximum(np.linalg.norm(db, axis=1), 1e-9)).astype(np.float32)
    qn = (q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)
          ).astype(np.float32)
    return db, q, qn, ids, inv


def _assert_masked(got, want, ids, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    bad = ids < 0
    assert np.all(got[bad] == INF32) and np.all(want[bad] == INF32)
    np.testing.assert_allclose(got[~bad], want[~bad], rtol=rtol, atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc for "
                    "sm_90a and have no CPU mode")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("R,d", [(1, 3), (9, 37), (32, 128), (11, 130)])
def test_gather_rows_dist_kernel_matches_plain(cuda, R, d):
    db, q, qn, ids, inv = _inputs(40, R, d, n=500, seed=R * d)
    idt, dbt, qt, qnt, invt = _on(cuda, ids, db, q, qn, inv)
    before = launch_counts()["gather_rows_dist"]
    for qq, iv in ((qt, None), (qnt, invt)):
        got = gather_rows_dist(idt, dbt, qq, iv)
        torch.cuda.synchronize()
        want = ref.gather_rows_dist_ref(idt, dbt, qq, iv)
        _assert_masked(got.cpu(), want.cpu(), ids, 1e-5, 1e-5)
    assert launch_counts()["gather_rows_dist"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("R,d", [(1, 3), (9, 37), (32, 128), (11, 200)])
def test_gather_rows_dist_q8_kernel_matches_plain(cuda, R, d):
    db, q, qn, ids, _ = _inputs(40, R, d, n=500, seed=R * d + 1)
    qdb = quantize_db(db)
    dp = qdb.codes.shape[1]
    pad = lambda x: np.pad(x, ((0, 0), (0, dp - d)))  # noqa: E731
    idt, codes, scale, zero, qt, qnt, inv = _on(
        cuda, ids, qdb.codes, qdb.scale, qdb.zero, pad(q), pad(qn), qdb.inv_norms)
    for qq, iv in ((qt, None), (qnt, inv)):
        got = gather_rows_dist_q8(idt, codes, scale, zero, qq, iv)
        torch.cuda.synchronize()
        want = ref.gather_rows_dist_q8_ref(idt, codes, scale, zero, qq, iv)
        _assert_masked(got.cpu(), want.cpu(), ids, 1e-5, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,d", [(5, 3, 7), (1000, 64, 128), (129, 130, 33)])
def test_twotower_score_kernel_matches_plain(cuda, B, H, d):
    rng = np.random.default_rng(B * H + d)
    q, h = _on(cuda, rng.standard_normal((B, d)).astype(np.float32),
               rng.standard_normal((H, d)).astype(np.float32))
    got = twotower_score(q, h)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(),
                               ref.twotower_score_ref(q, h).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
