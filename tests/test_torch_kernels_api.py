"""Kernel-API parity: ``repro_torch.kernels.ops`` on CPU tensors (the plain
versions) against ``repro``'s Pallas kernels in interpret mode, on the same
numpy inputs made from a seed.  Covers every shape and dtype case
tests/test_kernels.py runs for K4 ``topk_min``, K5 ``l2dist`` and K6
``gather_dist``, the ``mode`` dispatch, and the tie order of
``knn.topk_smallest`` / ``exact_knn``.

Tolerances, as tests/test_kernels.py holds the TPU kernels: l2dist and
gather_dist rtol=2e-5, atol=2e-4 in fp32 (the kernels take the dot form,
the plain versions sum in other orders) and 1e-2 from bf16; topk_min
indices equal and values equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # CI container has no hypothesis; run fixed examples
    from _hypothesis_fallback import given, settings, st

from repro.graphs.knn import exact_knn as j_exact_knn
from repro.kernels import ref as j_ref
from repro.kernels.gather_dist import gather_dist as j_gather_dist
from repro.kernels.l2dist import l2dist as j_l2dist
from repro.kernels.topk import topk_min as j_topk_min

from repro_torch.graphs.knn import exact_knn, topk_smallest
from repro_torch.kernels import launch_counts, ops, ref, reset_launch_counts

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ l2dist
@pytest.mark.parametrize(
    "Q,C,D",
    [(1, 1, 1), (7, 13, 5), (17, 33, 40), (128, 256, 128),
     (64, 200, 960), (200, 64, 200), (130, 129, 127)],
)
def test_l2dist_matches_pallas(Q, C, D):
    rng = np.random.default_rng(Q * C + D)
    q, c = _randn(rng, Q, D), _randn(rng, C, D)
    got = ops.l2dist(torch.from_numpy(q), torch.from_numpy(c)).numpy()
    want = np.asarray(j_l2dist(jnp.asarray(q), jnp.asarray(c), interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2dist_dtypes_match_pallas(dtype):
    rng = np.random.default_rng(1)
    q, c = _randn(rng, 32, 64), _randn(rng, 48, 64)
    tq, tc = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, c))
    jq, jc = (jnp.asarray(x).astype(getattr(jnp, dtype)) for x in (q, c))
    got = ops.l2dist(tq, tc).numpy()
    want = np.asarray(j_l2dist(jq, jc, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


def test_l2dist_self_distance_zero():
    x = torch.from_numpy(_randn(np.random.default_rng(2), 16, 32))
    assert float(torch.diag(ops.l2dist(x, x)).abs().max()) < 1e-3


# -------------------------------------------------------------------- topk
@pytest.mark.parametrize("B,C,k", [(1, 8, 1), (5, 100, 10), (37, 300, 10),
                                   (128, 512, 32), (64, 130, 64)])
def test_topk_min_matches_pallas(B, C, k):
    d = _randn(np.random.default_rng(B + C + k), B, C)
    v, i = ops.topk_min(torch.from_numpy(d), k)
    ve, ie = j_topk_min(jnp.asarray(d), k, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ie))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ve))
    assert i.dtype == torch.int32


def test_topk_min_with_inf_rows():
    d = np.full((4, 64), 3.4e38, np.float32)
    d[0, 5], d[0, 9] = -1.0, -2.0
    v, i = ops.topk_min(torch.from_numpy(d), 3)
    ve, ie = j_topk_min(jnp.asarray(d), 3, interpret=True)
    vr, ir = j_ref.topk_min_ref(jnp.asarray(d), 3)
    assert i[0, 0] == 9 and i[0, 1] == 5
    # fewer than k finite entries: 3.4e38 at the lowest such indices, as
    # repro's lax.top_k reference orders them
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))
    # the Pallas kernel agrees where a row has one 3.4e38 pick; on a row of
    # only 3.4e38 its mask (writing 3.4e38 over the pick) changes nothing,
    # so it returns index 0 k times
    np.testing.assert_array_equal(i.numpy()[0], np.asarray(ie)[0])
    np.testing.assert_array_equal(np.asarray(ie)[1:], 0)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ve))


@settings(max_examples=20, deadline=None)
@given(
    B=st.integers(1, 16), C=st.integers(2, 128),
    k=st.integers(1, 8), seed=st.integers(0, 2**31),
)
def test_topk_min_property(B, C, k, seed):
    k = min(k, C)
    d = np.random.default_rng(seed).standard_normal((B, C)).astype(np.float32)
    v, i = (x.numpy() for x in ops.topk_min(torch.from_numpy(d), k))
    assert (np.diff(v, axis=1) >= 0).all()
    np.testing.assert_array_equal(v, np.take_along_axis(d, i, 1))
    np.testing.assert_array_equal(v, np.sort(d, axis=1)[:, :k])


@pytest.mark.parametrize("k", [1, 2, 7])
def test_topk_min_ties_at_the_boundary_go_to_the_lowest_index(k):
    """Values in {0, 1, 2}: equal values straddle the k-th place in every
    row; the picks are lax.top_k's (lowest index first), which torch.topk
    does not promise."""
    d = np.random.default_rng(k).integers(0, 3, (4, 300)).astype(np.float32)
    d[0] = 0.0
    d[1, :] = 1.0
    d[1, 1] = 0.0
    v, i = ops.topk_min(torch.from_numpy(d), k)
    ve, ie = j_topk_min(jnp.asarray(d), k, interpret=True)
    vr, ir = j_ref.topk_min_ref(jnp.asarray(d), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ie))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vr))


def test_topk_min_rejects_k_outside_the_row():
    d = torch.zeros((2, 5))
    for k in (0, 6):
        with pytest.raises(ValueError, match="1 <= k <= C"):
            ops.topk_min(d, k)


# --------------------------------------------------- knn.topk_smallest ties
@pytest.mark.parametrize("exclude_self", [False, True])
def test_exact_knn_keeps_lax_top_k_order_on_duplicate_rows(exclude_self):
    """Duplicate db rows of small integers: every distance is exact in fp32
    whatever the summation order, so ids must equal repro's, whose
    ``lax.top_k`` sends ties to the lowest index."""
    rng = np.random.default_rng(7)
    base = rng.integers(-2, 3, (40, 8)).astype(np.float32)
    db = base[rng.integers(0, 40, 200)]
    q = db[:30] if exclude_self else rng.integers(-2, 3, (30, 8)).astype(np.float32)
    ids, dists = exact_knn(q, db, 9, exclude_self=exclude_self, q_chunk=16,
                           device="cpu")
    j_ids, j_dists = j_exact_knn(q, db, 9, exclude_self=exclude_self,
                                 q_chunk=16)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(dists, j_dists)


def test_topk_smallest_redoes_only_tied_rows():
    d = torch.tensor([[1.0, 0, 0, 0, 0, 0, 0, 0],
                      [5.0, 4, 3, 2, 1, 0, 6, 7]])
    vals, idx = topk_smallest(d, 2)
    assert idx.tolist() == [[1, 2], [5, 4]]
    assert vals.tolist() == [[0.0, 0.0], [0.0, 1.0]]


@pytest.mark.parametrize("k", [0, 1, 3, 11, 12])
def test_topk_smallest_equals_a_stable_sort(k):
    """Rows of small integers tie inside the first k, across the k-th
    place, and not at all; k = C has no (k+1)-th value to compare."""
    d = np.random.default_rng(k).integers(0, 4, (64, 12)).astype(np.float32)
    d[0] = np.arange(12)[::-1]
    vals, idx = topk_smallest(torch.from_numpy(d), k)
    want = np.argsort(d, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(d, want, 1))


# ------------------------------------------------------------- gather_dist
@pytest.mark.parametrize("B,R,D", [(1, 1, 1), (13, 20, 100), (8, 32, 128),
                                   (3, 64, 960)])
def test_gather_dist_matches_pallas(B, R, D):
    rng = np.random.default_rng(B * R + D)
    vecs, q = _randn(rng, B, R, D), _randn(rng, B, D)
    ids = rng.integers(-1, 50, (B, R)).astype(np.int32)
    got = ops.gather_dist(torch.from_numpy(vecs), torch.from_numpy(q),
                          torch.from_numpy(ids)).numpy()
    want = np.asarray(j_gather_dist(jnp.asarray(vecs), jnp.asarray(q),
                                    jnp.asarray(ids), interpret=True))
    bad = ids < 0
    assert np.all(got[bad] == np.float32(3.4e38))
    assert np.all(want[bad] == np.float32(3.4e38))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


def test_gather_dist_masks_invalid():
    rng = np.random.default_rng(4)
    vecs, q = _randn(rng, 4, 8, 16), _randn(rng, 4, 16)
    ids = np.full((4, 8), -1, np.int32)
    ids[:, 0] = 3
    out = ops.gather_dist(torch.from_numpy(vecs), torch.from_numpy(q),
                          torch.from_numpy(ids)).numpy()
    assert np.isfinite(out[:, 0]).all()
    assert (out[:, 1:] == np.float32(3.4e38)).all()


# ---------------------------------------------------------------- dispatch
def test_ops_modes_on_cpu_tensors():
    """auto, interpret and ref give the plain version on CPU tensors and
    launch nothing; cuda raises; an unknown mode raises."""
    rng = np.random.default_rng(5)
    q, c = torch.from_numpy(_randn(rng, 8, 16)), torch.from_numpy(_randn(rng, 9, 16))
    vecs = torch.from_numpy(_randn(rng, 8, 4, 16))
    ids = torch.from_numpy(rng.integers(-1, 9, (8, 4)).astype(np.int32))
    calls = {
        "l2dist": (lambda m: ops.l2dist(q, c, mode=m), lambda: ref.l2dist_ref(q, c)),
        "topk_min": (lambda m: ops.topk_min(c, 3, mode=m)[1],
                     lambda: ref.topk_min_ref(c, 3)[1]),
        "gather_dist": (lambda m: ops.gather_dist(vecs, q, ids, mode=m),
                        lambda: ref.gather_dist_ref(vecs, q, ids)),
        "twotower_score": (lambda m: ops.twotower_score(q, c, mode=m),
                           lambda: ref.twotower_score_ref(q, c)),
    }
    reset_launch_counts()
    for name, (call, plain) in calls.items():
        for mode in ("auto", "interpret", "ref"):
            assert torch.equal(call(mode), plain()), (name, mode)
        with pytest.raises(ValueError, match="CUDA tensors"):
            call("cuda")
        with pytest.raises(ValueError, match="mode"):
            call("pallas")
    assert set(launch_counts().values()) == {0}
    # repro's ops on the CPU take the same plain path
    np.testing.assert_allclose(
        ops.l2dist(q, c).numpy(),
        np.asarray(j_ref.l2dist_ref(jnp.asarray(q.numpy()), jnp.asarray(c.numpy()))),
        rtol=2e-5, atol=2e-4)
