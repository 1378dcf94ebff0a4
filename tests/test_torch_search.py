"""Search-core parity: ``repro_torch.graphs.search.batched_search`` against
``repro``'s on the same numpy inputs, on the CPU.

``repro`` runs its Pallas kernels in interpret mode
(``SearchParams(kernel_interpret=True)``), as tests/test_kernel_equiv.py
does; the port runs its kernels' plain versions (CPU tensors).

Tolerances: ids, hops, dist_evals and the integer telemetry must be equal.
Distances and float telemetry agree within rtol=1e-5, atol=1e-6: the two
frameworks sum the d products in different orders (fp32 rounding, ~1e-7
relative), and a cosine distance 1 − cos near 0 keeps the absolute error of
the ~1.0 sum it was taken from.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.graphs.params import SearchParams as JParams
from repro.graphs.search import batched_search as j_search
from repro.quant import QuantizedDb as JQuant
from repro.quant import quantize_db as j_quantize

from repro_torch.graphs.params import SearchParams
from repro_torch.graphs.search import batched_search
from repro_torch.quant import quantize_db


from test_kernel_equiv import _knn_problem, _problem

RTOL, ATOL = 1e-5, 1e-6
_INT_TELE = ("hops", "dist_evals", "ring_evictions", "converged_hop", "nav_hops")
_FLOAT_TELE = ("entry_dist", "bytes_read")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes that share the cores;
    torch's intra-op pool in each (one thread per core by default) would
    oversubscribe them and slow every worker many times over.  The other
    port test modules import this fixture to apply it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compare(db, nbrs, q, entries, sp_kw, *, kernel, metric, instrument):
    db, nbrs, q, entries = (np.array(a) for a in (db, nbrs, q, entries))
    kw = dict(sp_kw, kernel=kernel, metric=metric, instrument=instrument)
    jq = JQuant(*(jnp.asarray(a) for a in j_quantize(db)))
    a = j_search(jnp.asarray(db), jnp.asarray(nbrs), jnp.asarray(q),
                 jnp.asarray(entries), JParams(kernel_interpret=True, **kw),
                 quant=jq if kernel == "fused_q8" else None)
    b = batched_search(db, nbrs, q, entries, SearchParams(**kw),
                       quant=quantize_db(db) if kernel == "fused_q8" else None,
                       device="cpu")
    if instrument:
        (a, ta), (b, tb) = a, b
        for f in _INT_TELE:
            np.testing.assert_array_equal(
                getattr(tb, f).numpy(), np.asarray(getattr(ta, f)), err_msg=f)
        for f in _FLOAT_TELE:
            np.testing.assert_allclose(
                getattr(tb, f).numpy(), np.asarray(getattr(ta, f)),
                rtol=RTOL, atol=ATOL, err_msg=f)
        # entry_rank_proxy = entry_dist / top-1 dist: a cosine top-1 near 0
        # turns the last-bit difference of the sum into ~1e-4 relative, so
        # it is held to its definition over factors compared above
        np.testing.assert_array_equal(
            tb.entry_rank_proxy.numpy(),
            (tb.entry_dist / torch.clamp_min(b.dists[:, 0], 1e-12)).numpy())
        np.testing.assert_allclose(
            tb.entry_rank_proxy.numpy(), np.asarray(ta.entry_rank_proxy),
            rtol=1e-3)
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(a.ids))
    np.testing.assert_array_equal(b.hops.numpy(), np.asarray(a.hops))
    np.testing.assert_array_equal(b.dist_evals.numpy(), np.asarray(a.dist_evals))
    np.testing.assert_allclose(b.dists.numpy(), np.asarray(a.dists),
                               rtol=RTOL, atol=ATOL)


CASES = [(m, k, i) for m in ("l2", "cosine") for k in ("xla", "fused", "fused_q8")
         for i in (False, True)]


@pytest.mark.parametrize("metric,kernel,instrument", CASES)
def test_random_graph_parity(metric, kernel, instrument):
    """Random graph with -1 holes, odd d, two entries per query."""
    db, nbrs, q, entries = _problem(n=200, d=37, R=9, n_q=8, seed=3)
    _compare(db, nbrs, q, entries, dict(k=5, beam_width=8, max_hops=24),
             kernel=kernel, metric=metric, instrument=instrument)


@pytest.mark.parametrize("metric,kernel,instrument", CASES)
def test_knn_graph_parity(metric, kernel, instrument):
    """KNN graph where the search reaches high recall; a small visited ring
    (16 < max_hops) so ring evictions and their telemetry are exercised."""
    db, nbrs, q, entries, _ = _knn_problem(n=400, d=64, R=10, n_q=16)
    _compare(db, nbrs, q, entries,
             dict(k=10, beam_width=16, max_hops=48, visited_ring=16),
             kernel=kernel, metric=metric, instrument=instrument)


@pytest.mark.parametrize("fixture", ["small_nsg", "uniform_nsg"])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_nsg_parity(request, fixture, metric):
    """The conftest NSG indexes, medoid entry, both hop kernels,
    instrumented (``xla`` runs the same plain formula as ``fused`` on CPU
    tensors and is covered by the cases above)."""
    nsg = request.getfixturevalue(fixture)
    db = (request.getfixturevalue("small_db")[0] if fixture == "small_nsg"
          else request.getfixturevalue("uniform_db"))
    rng = np.random.default_rng(7)
    q = (db[rng.integers(0, len(db), 24)]
         + 0.05 * rng.standard_normal((24, db.shape[1]))).astype(np.float32)
    entries = np.full((24, 1), nsg.enter_id, np.int32)
    for kernel in ("fused", "fused_q8"):
        _compare(db, nsg.neighbors, q, entries,
                 dict(k=10, beam_width=32, max_hops=64),
                 kernel=kernel, metric=metric, instrument=True)


def test_q8_requires_codebook():
    db, nbrs, q, entries = (np.asarray(a) for a in _problem())
    with pytest.raises(ValueError, match="codebook"):
        batched_search(db, nbrs, q, entries, SearchParams(kernel="fused_q8"),
                       device="cpu")


def test_params_validation_matches_reference():
    for bad in (dict(metric="dot"), dict(kernel="pallas"), dict(k=0),
                dict(beam_width=True)):
        with pytest.raises(ValueError):
            JParams(**bad)
        with pytest.raises(ValueError):
            SearchParams(**bad)
    assert SearchParams() == SearchParams(**{
        f: getattr(JParams(), f) for f in SearchParams.__dataclass_fields__})


def test_frozen_queries_keep_their_state():
    """A batch mixing queries that finish early with ones that run to
    max_hops gives each query what it gets when searched alone."""
    db, nbrs, q, entries, _ = _knn_problem(n=400, d=64, R=10, n_q=16)
    sp = SearchParams(k=10, beam_width=16, max_hops=40, instrument=True)
    both, tb = batched_search(db, nbrs, q, entries, sp, device="cpu")
    assert len(set(both.hops.tolist())) > 1  # the lockstep loop mattered
    for i in (0, 5, 11):
        one, t1 = batched_search(db, nbrs, q[i:i + 1], entries[i:i + 1], sp,
                                 device="cpu")
        assert torch.equal(one.ids[0], both.ids[i])
        assert torch.equal(one.dists[0], both.dists[i])
        for f in _INT_TELE:
            assert getattr(t1, f)[0] == getattr(tb, f)[i], f


# ------------------------------------------- the rest of graphs/search.py
# beam_search_single and beam_search_fixed search one query; the reference
# is jitted once per case (its knobs static) and called per query.
# Tolerances: ids, hops, evals and integer telemetry equal; distances and
# float telemetry within rtol=1e-5, atol=1e-6 (the while-loop search, as
# above) or atol=1e-5 (beam_search_fixed's dot form ‖v‖² − 2v·q + ‖q‖²,
# whose terms are ~d before they cancel).

def _jit_single(fn, **static):
    import functools

    import jax

    return jax.jit(functools.partial(fn, **static))


def _assert_scalar_tele(tt, jt, atol):
    for f in _INT_TELE:
        assert int(getattr(tt, f)) == int(getattr(jt, f)), f
    for f in _FLOAT_TELE:
        np.testing.assert_allclose(float(getattr(tt, f)),
                                   float(getattr(jt, f)), rtol=RTOL,
                                   atol=atol, err_msg=f)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("kernel", ["xla", "fused", "fused_q8"])
@pytest.mark.parametrize("instrument", [False, True])
def test_beam_search_single_parity(metric, kernel, instrument):
    from repro.graphs.search import beam_search_single as j_single

    from repro_torch.graphs.search import beam_search_single

    db, nbrs, q, entries, _ = _knn_problem(n=400, d=64, R=10, n_q=16)
    kw = dict(beam_width=16, max_hops=48, visited_ring=16,
              instrument=instrument, metric=metric, kernel=kernel,
              rerank=10 if kernel == "fused_q8" else 0)
    quant = quantize_db(db) if kernel == "fused_q8" else None
    jquant = (JQuant(*(jnp.asarray(a) for a in j_quantize(db)))
              if kernel == "fused_q8" else None)
    jfn = _jit_single(j_single, kernel_interpret=True, **kw)
    for i in (0, 3, 9):
        a = jfn(jnp.asarray(db), jnp.asarray(nbrs), jnp.asarray(q[i]),
                jnp.asarray(entries[i]), quant=jquant)
        b = beam_search_single(db, nbrs, q[i], entries[i], quant=quant,
                               device="cpu", **kw)
        assert len(b) == len(a) == (5 if instrument else 4)
        np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))
        np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]),
                                   rtol=RTOL, atol=ATOL)
        assert b[2].shape == () and int(b[2]) == int(a[2])
        assert int(b[3]) == int(a[3])
        if instrument:
            assert b[4].hops.shape == ()
            _assert_scalar_tele(b[4], a[4], ATOL)


def test_beam_search_single_is_a_batch_of_one():
    """The port's single-query search is batched_search's loop: the same
    ids, distances and hops as the matching rows of a batched search."""
    from repro_torch.graphs.search import beam_search_single

    db, nbrs, q, entries, _ = _knn_problem(n=400, d=64, R=10, n_q=8)
    sp = SearchParams(k=16, beam_width=16, max_hops=48, kernel="fused")
    both = batched_search(db, nbrs, q, entries, sp, device="cpu")
    for i in range(len(q)):
        ids, d, hops, evals = beam_search_single(
            db, nbrs, q[i], entries[i], beam_width=16, max_hops=48,
            kernel="fused", device="cpu")
        assert torch.equal(ids, both.ids[i]) and torch.equal(d, both.dists[i])
        assert hops == both.hops[i] and evals == both.dist_evals[i]


@pytest.mark.parametrize("expand_width,visited_ring", [(1, 16), (2, 15)])
@pytest.mark.parametrize("instrument", [False, True])
@pytest.mark.parametrize("norms", [False, True])
def test_beam_search_fixed_parity(expand_width, visited_ring, instrument,
                                  norms):
    """Fixed trip count, E = 1 and a 2-wide wavefront; a ring of 15 makes
    the E = 2 ring write reach the end, where ``dynamic_update_slice``
    clamps its start."""
    from repro.graphs.search import beam_search_fixed as j_fixed

    from repro_torch.graphs.search import beam_search_fixed

    db, nbrs, q, entries, _ = _knn_problem(n=400, d=64, R=10, n_q=16)
    db_norms = (db * db).sum(axis=1) if norms else None
    kw = dict(beam_width=16, num_hops=20, visited_ring=visited_ring,
              expand_width=expand_width, instrument=instrument)
    jfn = _jit_single(j_fixed, **kw)
    for i in (1, 4, 12):
        a = jfn(jnp.asarray(db), jnp.asarray(nbrs), jnp.asarray(q[i]),
                jnp.asarray(entries[i]),
                db_norms=None if db_norms is None else jnp.asarray(db_norms))
        b = beam_search_fixed(db, nbrs, q[i], entries[i], db_norms=db_norms,
                              device="cpu", **kw)
        assert len(b) == len(a) == (4 if instrument else 3)
        np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))
        np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]),
                                   rtol=RTOL, atol=1e-5)
        assert int(b[2]) == int(a[2]) == 20 * expand_width
        if instrument:
            _assert_scalar_tele(b[3], a[3], 1e-5)
            assert b[3].ring_evictions > 0  # the ring wrapped


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_greedy_descent_parity(metric):
    """A walk over 64 nodes of out-degree 4 (-1 holes), from every 8th
    node, with and without the hop count; max_hops 3 cuts some walks."""
    import jax

    from repro.graphs.search import greedy_descent as j_search

    from repro_torch.graphs.search import greedy_descent

    j_descent = jax.jit(j_search, static_argnums=(4, 5),
                        static_argnames=("instrument",))

    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((64, 16)).astype(np.float32)
    nbrs = rng.integers(0, 64, (64, 4)).astype(np.int32)
    nbrs[rng.random((64, 4)) < 0.15] = -1
    nbrs[:, 0] = rng.integers(0, 64, 64)  # every node has a way out
    qs = rng.standard_normal((4, 16)).astype(np.float32)
    cut = 0
    for q in qs:
        for start in range(0, 64, 8):
            for max_hops in (3, 32):
                a_id, a_h = j_descent(jnp.asarray(vecs), jnp.asarray(nbrs),
                                      jnp.asarray(q), jnp.int32(start),
                                      max_hops, metric, instrument=True)
                b_id, b_h = greedy_descent(vecs, nbrs, q, start, max_hops,
                                           metric, instrument=True,
                                           device="cpu")
                assert int(b_id) == int(a_id) and int(b_h) == int(a_h)
                cut += int(a_h) == max_hops
                assert int(greedy_descent(vecs, nbrs, q, start, max_hops,
                                          metric, device="cpu")) == int(a_id)
    assert cut > 0


def test_search_jit_cache_size_counts_loaded_kernel_libraries():
    from repro_torch import search_jit_cache_size
    from repro_torch.kernels import _build

    db, nbrs, q, entries = (np.asarray(a) for a in _problem())
    n0 = search_jit_cache_size()
    assert n0 == len(_build._libs)
    for kernel in ("xla", "fused"):  # CPU tensors load no library
        batched_search(db, nbrs, q, entries, SearchParams(kernel=kernel),
                       device="cpu")
    assert search_jit_cache_size() == n0
