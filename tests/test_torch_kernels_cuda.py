"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: skipped without a CUDA card (the kernels are built with
nvcc for sm_90a and have no CPU mode).  Imports neither ``jax`` nor
``repro``, so it runs on a machine with only PyTorch:

    python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances: invalid slots exactly 3.4e38, ids >= N NaN; valid values within
rtol=1e-5, atol=1e-5 (the kernels split each sum over 32 lanes), and the
same bits at the paper's widths (K1's bulk path, K2's both paths), which
sum in the order of the plain version's CUDA reduction.  K3
``twotower_score``: rtol=atol=1e-5; its two paths (and K5's) give the same
bits, and each launch plan equals the wrapper module's ``plan``.  K4
``topk_min``: indices and values equal.  K5 ``l2dist`` and K6 ``gather_dist``
(dot form against the plain difference form): rtol=2e-5, atol=2e-4 in fp32,
1e-2 from bf16, as tests/test_kernels.py holds the TPU kernels.
``greedy_assign`` (port-only): every assignment equal to the plain version's.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    gather_rows_dist,
    gather_rows_dist_q8,
    launch_counts,
    twotower_score,
)
from repro_torch.kernels import ops, ref
from repro_torch.quant import quantize_db

INF32 = np.float32(3.4e38)


def _hop_ids(rng, B, R, n, case):
    """(B, R) ids into n rows.  "mixed": a third and ~20% more -1; "hop":
    the search's shape, ~85% -1, every 4th row -1 throughout and every 7th
    (from row 1) valid throughout; "full": every id valid; "oob": "hop"
    with ~5% of ids >= n (the kernels write NaN there)."""
    ids = rng.integers(0, n, (B, R)).astype(np.int32)
    if case == "mixed":
        ids[:, ::3] = -1
        ids[rng.random((B, R)) < 0.2] = -1
    elif case in ("hop", "oob", "misaligned"):
        ids[rng.random((B, R)) < 0.85] = -1
        ids[::4] = -1
        ids[1::7] = rng.integers(0, n, ids[1::7].shape)
        if case == "oob":
            oob = rng.random((B, R)) < 0.05
            ids[oob] = n + rng.integers(0, 5, int(oob.sum()))
    return ids


def _inputs(B, R, d, n=64, seed=0, case="mixed"):
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    ids = _hop_ids(rng, B, R, n, case)
    inv = (1.0 / np.maximum(np.linalg.norm(db, axis=1), 1e-9)).astype(np.float32)
    qn = (q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)
          ).astype(np.float32)
    return db, q, qn, ids, inv


def _assert_masked(got, want, ids, rtol, atol, n=None):
    """Invalid slots exactly 3.4e38; ids >= n (when given) NaN in ``got``;
    the rest within tolerance.  ``want`` comes from ids with the ids >= n
    set to -1 (the plain version would index out of bounds)."""
    got, want = np.asarray(got), np.asarray(want)
    bad = ids < 0
    assert np.all(got[bad] == INF32) and np.all(want[bad] == INF32)
    oob = ids >= n if n is not None else np.zeros_like(bad)
    assert np.all(np.isnan(got[oob]))
    ok = ~bad & ~oob
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc for "
                    "sm_90a and have no CPU mode")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _misaligned(t, offset_elems):
    """The same values in a contiguous view whose base is ``offset_elems``
    elements past an allocation (not 16-byte aligned)."""
    flat = torch.empty(t.numel() + offset_elems, dtype=t.dtype, device=t.device)
    view = flat[offset_elems:].view(t.shape)
    view.copy_(t)
    return view


# width 247 is the padded degree of the repaired 1M index the search runs
# on; "hop" rows are mostly -1, some -1 throughout, some valid throughout
# (more valid rows than one ring stage holds); R = 300 takes two passes of
# the front; d = 3, 37, 130 and a misaligned db take the register path
HOP_CASES = [(40, 1, 3, "mixed"), (40, 9, 37, "mixed"), (40, 32, 128, "mixed"),
             (40, 11, 130, "mixed"), (64, 247, 128, "hop"), (1, 247, 128, "full"),
             (1, 247, 128, "hop"), (10000, 247, 128, "hop"), (33, 247, 128, "oob"),
             (9, 300, 128, "hop"), (40, 247, 128, "misaligned"), (40, 247, 3, "hop"),
             (40, 247, 37, "hop"), (40, 247, 130, "oob"), (5, 247, 960, "hop")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,d,case", HOP_CASES)
def test_gather_rows_dist_kernel_matches_plain(cuda, B, R, d, case):
    n = 500
    db, q, qn, ids, inv = _inputs(B, R, d, n=n, seed=R * d + B, case=case)
    idt, safe, dbt, qt, qnt, invt = _on(cuda, ids, np.where(ids >= n, -1, ids),
                                        db, q, qn, inv)
    if case == "misaligned":
        dbt = _misaligned(dbt, 1)
    before = launch_counts()["gather_rows_dist"]
    for qq, iv in ((qt, None), (qnt, invt)):
        got = gather_rows_dist(idt, dbt, qq, iv)
        torch.cuda.synchronize()
        want = ref.gather_rows_dist_ref(safe, dbt, qq, iv)
        _assert_masked(got.cpu(), want.cpu(), ids, 1e-5, 1e-5, n)
    assert launch_counts()["gather_rows_dist"] == before + 2


# block 12 at d = 30 (Dp = 36) and block 20 at d = 100 (Dp = 100) are not
# multiples of 16 bytes: the register path; block 64 at d = 200 takes the
# bulk path with four (scale, zero) blocks a row
Q8_CASES = [(40, 1, 3, 128, "mixed"), (40, 9, 37, 128, "mixed"),
            (40, 32, 128, 128, "mixed"), (40, 11, 200, 128, "mixed"),
            (64, 247, 128, 128, "hop"), (1, 247, 128, 128, "full"),
            (10000, 247, 128, 128, "hop"), (33, 247, 128, 128, "oob"),
            (9, 300, 128, 128, "hop"), (40, 247, 128, 128, "misaligned"),
            (40, 247, 30, 12, "hop"), (40, 247, 100, 20, "oob"),
            (40, 247, 200, 64, "hop")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,d,block,case", Q8_CASES)
def test_gather_rows_dist_q8_kernel_matches_plain(cuda, B, R, d, block, case):
    n = 500
    db, q, qn, ids, _ = _inputs(B, R, d, n=n, seed=R * d + B + 1, case=case)
    qdb = quantize_db(db, block=block)
    dp = qdb.codes.shape[1]
    pad = lambda x: np.pad(x, ((0, 0), (0, dp - d)))  # noqa: E731
    idt, safe, codes, scale, zero, qt, qnt, inv = _on(
        cuda, ids, np.where(ids >= n, -1, ids), qdb.codes, qdb.scale, qdb.zero,
        pad(q), pad(qn), qdb.inv_norms)
    if case == "misaligned":
        codes = _misaligned(codes, 4)
    before = launch_counts()["gather_rows_dist_q8"]
    for qq, iv in ((qt, None), (qnt, inv)):
        got = gather_rows_dist_q8(idt, codes, scale, zero, qq, iv)
        torch.cuda.synchronize()
        want = ref.gather_rows_dist_q8_ref(safe, codes, scale, zero, qq, iv)
        _assert_masked(got.cpu(), want.cpu(), ids, 1e-5, 1e-5, n)
    assert launch_counts()["gather_rows_dist_q8"] == before + 2


# the paper's Table-2 widths (Dp = 128, 256, 384, 512, 1024 codes): the bulk
# paths and K2's register path sum in the order of PyTorch's vectorized CUDA
# reduction, so they give the plain version's bits; values of ~1e3 (a
# spread of 8) make the last bit of each sum depend on that order
@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 200, 384, 512, 960])
def test_hop_kernels_bit_equal_at_table2_widths(cuda, d):
    n, B, R = 2000, 512, 247
    rng = np.random.default_rng(d)
    db = (8.0 * rng.standard_normal((n, d))).astype(np.float32)
    q = (8.0 * rng.standard_normal((B, d))).astype(np.float32)
    ids = rng.integers(0, n, (B, R)).astype(np.int32)
    ids[rng.random((B, R)) < 0.1] = -1
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    inv = (1.0 / np.linalg.norm(db, axis=1)).astype(np.float32)
    qdb = quantize_db(db)
    dp = qdb.codes.shape[1]
    pad = lambda x: np.pad(x, ((0, 0), (0, dp - d)))  # noqa: E731
    idt, dbt, qt, qnt, invt, codes, scale, zero, qp, qnp, qinv = _on(
        cuda, ids, db, q, qn.astype(np.float32), inv, qdb.codes, qdb.scale,
        qdb.zero, pad(q), pad(qn).astype(np.float32), qdb.inv_norms)
    for qq, iv in ((qt, None), (qnt, invt)):
        got = gather_rows_dist(idt, dbt, qq, iv)
        want = ref.gather_rows_dist_ref(idt, dbt, qq, iv)
        torch.cuda.synchronize()
        assert torch.equal(got, want), float((got - want).abs().max())
    for qq, iv in ((qp, None), (qnp, qinv)):
        for c in (codes, _misaligned(codes, 4)):  # bulk, then register path
            got = gather_rows_dist_q8(idt, c, scale, zero, qq, iv)
            want = ref.gather_rows_dist_q8_ref(idt, codes, scale, zero, qq, iv)
            torch.cuda.synchronize()
            assert torch.equal(got, want), float((got - want).abs().max())


# the ring rows that csrc/gather_dist.cu sizes at the Table-2 widths: K1's
# rows are 4·d bytes, K2's the code width padded to 128-code blocks
@pytest.mark.cuda
@pytest.mark.parametrize("d,k1,k2", [(128, 32, 32), (200, 20, 32),
                                     (384, 10, 32), (512, 8, 32),
                                     (960, 4, 16)])
def test_ring_rows_at_table2_widths(cuda, d, k1, k2):
    from repro_torch.kernels.gather_dist import ring_rows
    from repro_torch.quant import BLOCK

    assert ring_rows(4 * d) == k1
    assert ring_rows(-(-d // BLOCK) * BLOCK) == k2
    assert ring_rows(1 << 20) == 2 and ring_rows(4) == 32


# (10,000, 64, 128) and (1024, 64, 128) are the search's and a serve
# request's shapes; up to 128 hubs of width up to 128 (multiples of 4) take
# the resident path, the rest (H = 129, 130, 512; d = 7, 33, 512) the tiled
# one; "row" is a view one row into its allocation (aligned), "elem" one
# element in (misaligned: the tiled path)
K3_CASES = [(5, 3, 7, None), (1000, 64, 128, None), (129, 130, 33, None),
            (1, 64, 128, None), (1024, 64, 128, None), (10000, 64, 128, None),
            (1024, 128, 128, None), (77, 12, 36, None), (1024, 129, 128, None),
            (300, 512, 128, None), (1024, 64, 7, None), (1024, 64, 33, None),
            (64, 64, 512, None), (1024, 64, 128, "row"), (1024, 64, 128, "elem"),
            (33, 4, 8, None), (1000, 100, 64, None), (5000, 64, 128, None)]


def _k3_inputs(cuda, B, H, d, view):
    rng = np.random.default_rng(B * H + d)
    q, h = _on(cuda, rng.standard_normal((B, d)).astype(np.float32),
               rng.standard_normal((H, d)).astype(np.float32))
    if view is not None:
        q = _misaligned(q, d if view == "row" else 1)
    return q, h


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,d,view", K3_CASES)
def test_twotower_score_kernel_matches_plain(cuda, B, H, d, view):
    q, h = _k3_inputs(cuda, B, H, d, view)
    TT = importlib.import_module("repro_torch.kernels.twotower_score")
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    want_plan = TT.plan(B, H, d, n_sm=n_sm, aligned=view != "elem")
    assert TT.cuda_plan(q, h) == want_plan
    resident = H <= 128 and H % 4 == 0 and d <= 128 and d % 4 == 0
    assert want_plan["path"] == ("resident" if resident and view != "elem"
                                 else "tiled")
    before = launch_counts()["twotower_score"]
    got = twotower_score(q, h)
    torch.cuda.synchronize()
    assert launch_counts()["twotower_score"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               ref.twotower_score_ref(q, h).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,d", [(1024, 64, 128), (10000, 64, 128),
                                   (333, 128, 124), (40, 8, 4)])
def test_twotower_score_paths_give_the_same_bits(cuda, B, H, d):
    """The resident path and the tiled one (a misaligned view of the same
    queries) round every output alike."""
    q, h = _k3_inputs(cuda, B, H, d, None)
    resident = twotower_score(q, h)
    tiled = twotower_score(_misaligned(q, 1), h)
    torch.cuda.synchronize()
    assert torch.equal(resident, tiled)


# ----------------------------------------------- K4 topk_min, K5 l2dist, K6
@pytest.mark.cuda
@pytest.mark.parametrize("B,C,k", [(1, 8, 1), (5, 100, 10), (37, 300, 10),
                                   (128, 512, 32), (64, 130, 64), (7, 9, 9),
                                   (3, 20000, 7), (2, 65536, 5)])
def test_topk_min_kernel_matches_plain(cuda, B, C, k):
    """Random rows, rows of exact ties (values in {0, 1, 2}), rows of
    3.4e38 and signed zeros; C from one row per thread to a row wider than
    shared memory."""
    rng = np.random.default_rng(B * C + k)
    rows = [rng.standard_normal((B, C)).astype(np.float32),
            rng.integers(0, 3, (B, C)).astype(np.float32),
            np.full((B, C), INF32, np.float32),
            np.where(rng.random((B, C)) < 0.5, -0.0, 0.0).astype(np.float32)]
    rows[2][:, ::7] = -1.0
    before = launch_counts()["topk_min"]
    for d in rows:
        (dt,) = _on(cuda, d)
        v, i = ops.topk_min(dt, k, mode="cuda")
        torch.cuda.synchronize()
        ve, ie = ref.topk_min_ref(dt, k)
        np.testing.assert_array_equal(i.cpu().numpy(), ie.cpu().numpy())
        np.testing.assert_array_equal(v.cpu().numpy(), ve.cpu().numpy())
    assert launch_counts()["topk_min"] == before + len(rows)


# (1024, 8192) and (1024, 65,536) at d = 128 are the kernel API path's
# shapes; Q and C off the 128 x 128 tile; d = 960; widths that are not a
# multiple of 4 (fp32) or 8 (bf16) take the tiled path
K5_CASES = [(1, 1, 1), (7, 13, 5), (17, 33, 40), (128, 256, 128),
            (64, 200, 960), (130, 129, 127), (1024, 8192, 128),
            (1024, 65536, 128), (300, 1000, 128), (129, 70000, 64),
            (5, 3, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("Q,C,D", K5_CASES)
def test_l2dist_kernel_matches_plain(cuda, Q, C, D):
    rng = np.random.default_rng(Q + C + D)
    q, c = _on(cuda, rng.standard_normal((Q, D)).astype(np.float32),
               rng.standard_normal((C, D)).astype(np.float32))
    L2 = importlib.import_module("repro_torch.kernels.l2dist")
    before = launch_counts()["l2dist"]
    for qq, cc, tol, bf16 in ((q, c, (2e-5, 2e-4), False),
                              (q.to(torch.bfloat16), c.to(torch.bfloat16),
                               (1e-2, 1e-2), True)):
        want_plan = L2.plan(Q, C, D, bf16=bf16)
        assert L2.cuda_plan(qq, cc) == want_plan
        assert want_plan["path"] == ("sgemm" if D % (8 if bf16 else 4) == 0
                                     else "tiled")
        got = ops.l2dist(qq, cc, mode="cuda")
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(),
                                   ref.l2dist_ref(qq, cc).cpu().numpy(),
                                   rtol=tol[0], atol=tol[1])
        del got
    assert launch_counts()["l2dist"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("Q,C,D", [(1024, 8192, 128), (130, 300, 64),
                                   (33, 65, 960)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2dist_paths_give_the_same_bits(cuda, Q, C, D, dtype):
    """The SGEMM path and the tiled one (a misaligned view of the same
    candidates) round every output alike."""
    rng = np.random.default_rng(Q * C + D)
    q, c = _on(cuda, rng.standard_normal((Q, D)).astype(np.float32),
               rng.standard_normal((C, D)).astype(np.float32))
    q, c = q.to(dtype), c.to(dtype)
    sgemm = ops.l2dist(q, c, mode="cuda")
    tiled = ops.l2dist(q, _misaligned(c, 1), mode="cuda")
    torch.cuda.synchronize()
    assert torch.equal(sgemm, tiled)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,D", [(1, 1, 1), (13, 20, 100), (8, 32, 128),
                                   (3, 64, 960), (1024, 32, 128), (5, 9, 37)])
def test_gather_dist_kernel_matches_plain(cuda, B, R, D):
    rng = np.random.default_rng(B * R + D)
    ids = rng.integers(-1, 50, (B, R)).astype(np.int32)
    vecs, q, idt = _on(cuda, rng.standard_normal((B, R, D)).astype(np.float32),
                       rng.standard_normal((B, D)).astype(np.float32), ids)
    got = ops.gather_dist(vecs, q, idt, mode="cuda")
    torch.cuda.synchronize()
    _assert_masked(got.cpu(), ref.gather_dist_ref(vecs, q, idt).cpu(), ids,
                   2e-5, 2e-4)


# ------------------------------------------ K4's select path and K6's paths
def _topk_rows(rng, B, C, k, kind):
    """(B, C) rows of one kind: "normal"; "ties" (values in {0, 1, 2});
    "straddle" (k - 2 zeros at random places in a row of 2.0, so the k-th
    place falls inside the run of equal values); "inf" (3.4e38 with every
    7th -1.0); "special" (normal with NaNs, -0.0, +0.0, +-inf)."""
    if kind == "normal":
        return rng.standard_normal((B, C)).astype(np.float32)
    if kind == "ties":
        return rng.integers(0, 3, (B, C)).astype(np.float32)
    if kind == "straddle":
        d = np.full((B, C), 2.0, np.float32)
        for row in d:
            row[rng.choice(C, max(0, min(k - 2, C)), replace=False)] = 0.0
        return d
    if kind == "inf":
        d = np.full((B, C), INF32, np.float32)
        d[:, ::7] = -1.0
        return d
    d = rng.standard_normal((B, C)).astype(np.float32)
    pick = rng.random((B, C))
    d[pick < 0.1] = np.nan
    d[(pick >= 0.1) & (pick < 0.2)] = -0.0
    d[(pick >= 0.2) & (pick < 0.3)] = 0.0
    d[(pick >= 0.3) & (pick < 0.32)] = np.inf
    d[(pick >= 0.32) & (pick < 0.34)] = -np.inf
    return d


# C = 130 puts every odd row 8 bytes off 16; C = 9 every row but each 4th;
# "elem" / "two" are views 1 / 2 elements past an allocation; k = 32 is the
# select path's cap and k = 33 the pass path's first; (1024, 65,536, 10)
# and (256, 1024, 32) are the kernel API path's shapes
TOPK_CASES = [(64, 130, 10, None), (64, 130, 32, None), (64, 130, 33, None),
              (33, 9, 9, None), (33, 9, 1, None), (256, 1024, 32, None),
              (256, 1024, 33, None), (50, 1000, 10, "elem"),
              (50, 1000, 32, "two"), (7, 5000, 17, "elem"), (3, 3, 3, None),
              (100, 4, 1, "elem"), (2, 20000, 33, None),
              (1024, 65536, 10, None), (1, 1_000_000, 10, None),
              (1, 1_000_000, 32, "elem")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,k,view", TOPK_CASES)
def test_topk_min_paths_give_the_stable_sort(cuda, B, C, k, view):
    """Both paths, rows at every 4-byte offset, NaNs and signed zeros, ties
    across the k-th place: indices and values bit-equal to the stable sort;
    the source's plan equals ``plan()``."""
    TK = importlib.import_module("repro_torch.kernels.topk")
    rng = np.random.default_rng(B + C + k)
    kinds = (("normal", "special") if B * C > 10**7 else
             ("normal", "ties", "straddle", "inf", "special"))
    want_plan = TK.plan(B, C, k)
    assert want_plan["path"] == ("select" if k <= 32 else "passes")
    for kind in kinds:
        (dt,) = _on(cuda, _topk_rows(rng, B, C, k, kind))
        if view is not None:
            dt = _misaligned(dt, 1 if view == "elem" else 2)
        assert TK.cuda_plan(dt, k) == want_plan
        v, i = TK.topk_min(dt, k)
        torch.cuda.synchronize()
        ve, ie = ref.topk_min_ref(dt, k)
        assert torch.equal(i, ie), kind
        assert torch.equal(v.view(torch.int32), ve.view(torch.int32)), kind
        del dt, v, i, ve, ie


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,D", [(1024, 32, 128), (9, 300, 64), (5, 40, 960),
                                   (40, 247, 128)])
def test_gather_dist_paths_give_the_same_bits(cuda, B, R, D):
    """The bulk path and the register path (a misaligned view of the same
    rows, or of the same query) round every slot alike; invalid slots are
    exactly 3.4e38."""
    rng = np.random.default_rng(B * R + D)
    ids = rng.integers(-1, 50, (B, R)).astype(np.int32)
    vecs, q, idt = _on(cuda, rng.standard_normal((B, R, D)).astype(np.float32),
                       rng.standard_normal((B, D)).astype(np.float32), ids)
    bulk = ops.gather_dist(vecs, q, idt, mode="cuda")
    regs = ops.gather_dist(_misaligned(vecs, 1), q, idt, mode="cuda")
    regs_q = ops.gather_dist(vecs, _misaligned(q, 1), idt, mode="cuda")
    torch.cuda.synchronize()
    assert torch.equal(bulk, regs) and torch.equal(bulk, regs_q)
    _assert_masked(bulk.cpu(), ref.gather_dist_ref(vecs, q, idt).cpu(), ids,
                   2e-5, 2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("D,view", [(128, None), (128, "elem"), (37, None)])
def test_gather_dist_reads_only_the_sign_of_an_id(cuda, D, view):
    """Ids up to 2^30 are valid rows (a distance, never NaN: the rows are
    already gathered); rows of -1 throughout give exactly 3.4e38."""
    B, R = 64, 32
    rng = np.random.default_rng(D)
    ids = rng.integers(1 << 20, 1 << 30, (B, R)).astype(np.int32)
    ids[::3] = -1
    ids[1::3, ::5] = -1
    vecs, q, idt = _on(cuda, rng.standard_normal((B, R, D)).astype(np.float32),
                       rng.standard_normal((B, D)).astype(np.float32), ids)
    if view == "elem":
        vecs = _misaligned(vecs, 1)
    got = ops.gather_dist(vecs, q, idt, mode="cuda")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert bool((got[::3] == float(INF32)).all())
    _assert_masked(got.cpu(), ref.gather_dist_ref(vecs, q, idt).cpu(), ids,
                   2e-5, 2e-4)


def _greedy_d2(rng, n, k, case):
    """(n, k) squared distances: "real" from points and centres as hbkm
    computes them; "ties" small integers (ties on most rows, one row all
    tied); "tied" every row all tied (the penalty alone decides)."""
    if case == "real":
        x = rng.standard_normal((n, 16)).astype(np.float32)
        c = x[rng.choice(n, size=min(k, n), replace=n < k)]
        d2 = ((x * x).sum(1, keepdims=True) - 2.0 * x @ c.T
              + (c * c).sum(1)[None, :]).astype(np.float32)
    elif case == "ties":
        d2 = rng.integers(0, 3, (n, k)).astype(np.float32)
        d2[n // 2] = 1.0
    else:
        d2 = np.full((n, k), 2.5, np.float32)
    return d2


GREEDY_CASES = ([(k, n, "real") for k in (2, 8, 32) for n in (1, 1000, 20000)]
                + [(k, n, c) for k in (2, 8, 32) for n in (1, 1000)
                   for c in ("ties", "tied")])


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,case", GREEDY_CASES)
def test_greedy_assign_kernel_matches_plain(cuda, k, n, case):
    from repro_torch.kernels import greedy_assign

    rng = np.random.default_rng(n + k)
    d2 = _greedy_d2(rng, n, k, case)
    lam = float(np.float32(0.37 if case == "real" else 0.5))
    target = float(np.float32(n) / np.float32(k))
    before = launch_counts()["greedy_assign"]
    got = greedy_assign(torch.from_numpy(d2).to(cuda), lam, target)
    assert launch_counts()["greedy_assign"] == before + 1
    want = ref.greedy_assign_ref(torch.from_numpy(d2), lam, target)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    counts = np.bincount(want.numpy(), minlength=k)
    assert counts.sum() == n
    if case == "tied":  # the penalty alone: round robin over the clusters
        assert counts.max() - counts.min() <= 1
