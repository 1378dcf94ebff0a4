"""``GateIndex`` parity at the paper's other widths, on a mixed query log.

A ``repro`` index is built on 1,000 rows of text2image10m-like (d = 200)
and of gist1m-like (d = 960), trained on a 50/50 log of in-distribution and
out-of-distribution historical queries (``bench_ood``'s setting), and
carried across with ``repro_torch.convert.index_from_numpy``.  Both
packages then search the same in-distribution and OOD evaluation queries
with every kernel (``repro``'s Pallas kernels in interpret mode), under l2
and cosine, on the flat-score entry path and on the nav-graph descent
path.  Entries, hops, ring evictions and converged hops are equal.

Under l2 ids and dist_evals are equal, and distances within rtol = atol =
1e-5, as tests/test_torch_gate_index.py holds them at d = 128.  Under
cosine the two packages sum a row's d terms in another order, and 1 - cos
rounds differently in its last bit (~6e-8): that decides near ties.  So
under cosine:
- at d = 960 ids are equal as sets per row, and in order wherever the
  reference's adjacent distances differ by more than 1e-6 (a probe with 48
  queries, beam 32: 2 of 480 slots traded places, row 41, ids 88 and 675
  at 1.77819e-3 and 1.77830e-3);
- at both widths a near tie inside the beam can swap which of two nodes
  is expanded first, or which one the beam drops, and the walk then
  scores a few candidates more or less: dist_evals may differ on at most
  one query of a batch, by at most 5% of the reference's count.  Measured:
  d = 200, xla, query 1 of 48: ids 465 and 703 at 3.936887e-3 and
  3.9369464e-3 in ``repro``, 3.936887e-3 and 3.9367676e-3 in the port,
  swapped at hop 5, 317 evals against 316; d = 200, fused_q8, query 4 of
  16: the q8 distances of ids 816 and 882 tie at the beam's last slot at
  hop 11, 3 evals apart; d = 960, 1 eval apart on one query with every
  kernel.
The largest distance differences measured before this test was written
(48 queries, beam 32): at d = 200 / 512 9.2e-5 / 1.8e-4 under l2 and at
most 3.6e-7 under cosine; at d = 960 4.9e-4 under l2.  ``repro``'s fused
kernels run in interpret mode, ~0.45 s a query at d = 960 (beam 32, 96
hops), so each batch holds 12 queries and a walk at most 64 hops.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import GateConfig as JConfig
from repro.core import GateIndex as JIndex
from repro.data.synthetic import (
    make_database,
    make_queries_in_dist,
    make_queries_ood,
    train_eval_query_split,
)
from repro.graphs.nsg import build_nsg as j_build_nsg
from repro.graphs.params import SearchParams as JParams

from repro_torch import SearchParams
from repro_torch.convert import index_from_numpy

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

JCFG = JConfig(n_hubs=24, epochs=30, batch_hubs=24, subgraph_max_nodes=48)
# where summation order may swap near-tied ids (see the module docstring)
TIE_WIDTH = 960
TIE_GAP = 1e-6
N_QUERIES = 12


@pytest.fixture(scope="module", params=["text2image10m-like", "gist1m-like"])
def carried(request):
    """A 1,000-row ``repro`` index of ``request.param`` trained on a 50/50
    log, the port's copy of it, and 12 in-distribution and 12 OOD queries."""
    db, _ = make_database(request.param, 1000, seed=1)
    nsg = j_build_nsg(db, R=16, knn_k=16, search_l=32, pool_size=48)
    tq, _ = train_eval_query_split(db, 192, 48, ood_fraction=0.5)
    jidx = JIndex.from_graph(db, nsg.neighbors, nsg.enter_id, tq, JCFG)
    jidx.ensure_quantized()
    state = {
        "db": jidx.db, "neighbors": jidx.neighbors, "enter_id": jidx.enter_id,
        "hubs": (jidx.hubs.ids, jidx.hubs.assign, jidx.hubs.centroids),
        "tower_params": jax.tree.map(np.asarray, jidx.tower_params),
        "tower_cfg": dataclasses.asdict(jidx.tower_cfg),
        "gcfg": dataclasses.asdict(jidx.gcfg),
        "nav": (jidx.nav.neighbors, jidx.nav.reps, jidx.nav.start),
        "build_report": jidx.build_report,
        "quant": tuple(jidx.quant),
    }
    queries = {"in_dist": make_queries_in_dist(db, N_QUERIES, seed=17),
               "ood": make_queries_ood(db, N_QUERIES, seed=17)}
    return jidx, index_from_numpy(state, device="cpu"), queries


def _flat_limit(idx, flat_score_max):
    idx.gcfg = dataclasses.replace(idx.gcfg, flat_score_max=flat_score_max)


def assert_ids_equal_up_to_near_ties(got, want, want_d, gap=TIE_GAP):
    """Equal ids as sets per row, and in order at every slot whose
    reference distance is more than ``gap`` from both of its neighbours'."""
    for row in range(len(want)):
        assert set(got[row]) == set(want[row]), row
    d = want_d.astype(np.float64)
    near = np.zeros(d.shape, bool)
    close = np.abs(np.diff(d, axis=1)) <= gap
    near[:, 1:] |= close
    near[:, :-1] |= close
    np.testing.assert_array_equal(got[~near], want[~near])


def assert_evals_equal_up_to_one_near_tie(got, want, rel=0.05):
    """dist_evals equal but on at most one query, and there within ``rel``
    of the reference's count."""
    diff = np.abs(got.astype(np.int64) - want)
    assert (diff > 0).sum() <= 1, (got, want)
    assert np.all(diff <= rel * want), (got, want)


@pytest.mark.parametrize("qtype", ["in_dist", "ood"])
@pytest.mark.parametrize("entry_path", ["flat_score", "nav_descent"])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("kernel", ["xla", "fused", "fused_q8"])
def test_carried_index_searches_alike_at_width(carried, kernel, metric,
                                               entry_path, qtype):
    jidx, tidx, queries = carried
    q = queries[qtype]
    limit = 128 if entry_path == "flat_score" else 8  # n_hubs = 24
    _flat_limit(jidx, limit)
    _flat_limit(tidx, limit)
    kw = dict(k=10, beam_width=32, max_hops=64, kernel=kernel, metric=metric,
              instrument=True)
    ja, jt = jidx.search(q, params=JParams(kernel_interpret=True, **kw),
                         telemetry_sink=None)
    ta, tt = tidx.search(q, params=SearchParams(**kw), device="cpu")
    np.testing.assert_array_equal(
        tidx.select_entries(q, device="cpu").numpy(),
        np.asarray(jidx.select_entries(q)))
    got, want = ta.ids.numpy(), np.asarray(ja.ids)
    if metric == "cosine" and q.shape[1] == TIE_WIDTH:
        assert_ids_equal_up_to_near_ties(got, want, np.asarray(ja.dists))
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(ta.dists.numpy(), np.asarray(ja.dists),
                               rtol=1e-5, atol=1e-5)
    for f in ("hops", "ring_evictions", "converged_hop", "nav_hops"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    evals, want_evals = tt.dist_evals.numpy(), np.asarray(jt.dist_evals)
    if metric == "cosine":
        assert_evals_equal_up_to_one_near_tie(evals, want_evals)
    else:
        np.testing.assert_array_equal(evals, want_evals)
    if entry_path == "nav_descent":
        assert tt.nav_hops.max() > 0


def test_near_tie_rules_accept_a_swap_and_refuse_a_move():
    """The cosine rules: a swap of two ids whose reference distances are
    within the gap passes; a swap across a wider gap, or an id that is not
    in the reference's row, fails; one query's evals off by 5% pass, off
    by more or on two queries fail."""
    want = np.array([[5, 88, 675, 9]])
    want_d = np.array([[1.0e-3, 1.77819e-3, 1.77830e-3, 2.5e-3]], np.float32)
    assert_ids_equal_up_to_near_ties(np.array([[5, 675, 88, 9]]), want,
                                     want_d, gap=2e-7)
    with pytest.raises(AssertionError):
        assert_ids_equal_up_to_near_ties(np.array([[88, 5, 675, 9]]), want,
                                         want_d, gap=2e-7)
    with pytest.raises(AssertionError):
        assert_ids_equal_up_to_near_ties(np.array([[5, 88, 675, 10]]), want,
                                         want_d, gap=2e-7)
    evals = np.array([234, 300, 356])
    assert_evals_equal_up_to_one_near_tie(np.array([234, 315, 356]), evals)
    for off in ([234, 316, 356], [235, 301, 356]):
        with pytest.raises(AssertionError):
            assert_evals_equal_up_to_one_near_tie(np.array(off), evals)


@pytest.mark.parametrize("blocks", [4, 8])
def test_hop_kernel_probe_variant_changes_only_k2s_bound(tmp_path, blocks):
    """tools/hop_kernel_probe.py times K2 at other register bounds: each
    variant is the port's gather_dist.cu with ``rows_q8_bulk``'s
    ``__launch_bounds__`` changed and nothing else, beside its headers."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "hop_kernel_probe", root / "tools" / "hop_kernel_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = root / "src" / "repro_torch" / "csrc" / "gather_dist.cu"
    out = probe.variant(src, blocks, tmp_path)
    old, new = src.read_text().splitlines(), out.read_text().splitlines()
    changed = [(a, b) for a, b in zip(old, new) if a != b]
    assert len(old) == len(new) and changed == [
        ("__global__ void __launch_bounds__(kThreads, 5)",
         f"__global__ void __launch_bounds__(kThreads, {blocks})")]
    assert (out.parent / "async_copy.cuh").read_text() == \
        (src.parent / "async_copy.cuh").read_text()
