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
