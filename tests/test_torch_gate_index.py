"""``GateIndex`` parity.

1. A ``repro``-built index carried across with
   ``repro_torch.convert.index_from_numpy`` searches to the same ids (dists
   within 1e-5) for every kernel, on the flat-score entry path and on the
   nav-graph descent path, with equal telemetry.  ``repro`` runs its Pallas
   kernels in interpret mode.
2. An index built by the port on the CPU passes ``repro``'s own quality
   checks (tests/test_gate_index.py): training lowers the loss, every hub has
   a positive, and GATE's recall@10 is within 0.02 of the baseline's or
   better at the same budget.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import GateConfig as JConfig
from repro.core import GateIndex as JIndex
from repro.data.synthetic import make_database, train_eval_query_split
from repro.graphs.nsg import build_nsg as j_build_nsg
from repro.graphs.params import SearchParams as JParams

from repro_torch import GateConfig, GateIndex, SearchParams, exact_knn, recall_at_k
from repro_torch.convert import index_from_numpy

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

JCFG = JConfig(n_hubs=24, epochs=30, batch_hubs=24, subgraph_max_nodes=48)


@pytest.fixture(scope="module")
def carried():
    """A ~1000-point index built by ``repro``, carried across as the dict
    ``GateIndex.save`` pickles (dataclasses as dicts, arrays as numpy)."""
    db, _ = make_database("sift10m-like", 1000, seed=1)
    nsg = j_build_nsg(db, R=16, knn_k=16, search_l=32, pool_size=48)
    tq, eq = train_eval_query_split(db, 192, 48)
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
    return jidx, index_from_numpy(state, device="cpu"), eq


def _flat_limit(idx, flat_score_max):
    idx.gcfg = dataclasses.replace(idx.gcfg, flat_score_max=flat_score_max)


@pytest.mark.parametrize("entry_path", ["flat_score", "nav_descent"])
@pytest.mark.parametrize("kernel", ["xla", "fused", "fused_q8"])
def test_carried_index_searches_alike(carried, entry_path, kernel):
    jidx, tidx, eq = carried
    limit = 128 if entry_path == "flat_score" else 8  # n_hubs = 24
    _flat_limit(jidx, limit)
    _flat_limit(tidx, limit)
    kw = dict(k=10, beam_width=32, max_hops=96, kernel=kernel, instrument=True)
    ja, jt = jidx.search(eq, params=JParams(kernel_interpret=True, **kw),
                         telemetry_sink=None)
    ta, tt = tidx.search(eq, params=SearchParams(**kw), device="cpu")
    np.testing.assert_array_equal(
        tidx.select_entries(eq, device="cpu").numpy(),
        np.asarray(jidx.select_entries(eq)))
    np.testing.assert_array_equal(ta.ids.numpy(), np.asarray(ja.ids))
    np.testing.assert_allclose(ta.dists.numpy(), np.asarray(ja.dists),
                               rtol=1e-5, atol=1e-5)
    for f in ("hops", "dist_evals", "ring_evictions", "converged_hop",
              "nav_hops"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    np.testing.assert_allclose(tt.bytes_read.numpy(), np.asarray(jt.bytes_read),
                               rtol=1e-5)
    if entry_path == "nav_descent":
        assert tt.nav_hops.max() > 0


def test_carried_index_baseline_and_memory(carried):
    jidx, tidx, eq = carried
    sp = dict(k=10, beam_width=16, max_hops=64)
    for entry in ("medoid", "random"):
        ja = jidx.search_baseline(eq, params=JParams(**sp), entry=entry,
                                  telemetry_sink=None)
        ta = tidx.search_baseline(eq, params=SearchParams(**sp), entry=entry,
                                  device="cpu")
        np.testing.assert_array_equal(ta.ids.numpy(), np.asarray(ja.ids))
    assert tidx.memory_bytes() == jidx.memory_bytes()


@pytest.fixture(scope="module")
def port_built():
    db, _ = make_database("sift10m-like", 2000, seed=0)
    tq, eq = train_eval_query_split(db, 384, 96)
    gcfg = GateConfig(n_hubs=48, epochs=60, batch_hubs=48, subgraph_max_nodes=64)
    idx = GateIndex.build(db, tq, gcfg, R=32, knn_k=32, search_l=64,
                          pool_size=96, device="cpu")
    return idx, eq


def test_port_built_index_quality(port_built):
    idx, eq = port_built
    rep = idx.build_report
    assert rep["loss_last"] < rep["loss_first"]
    assert rep["samples"]["hub_with_no_pos"] == 0
    for t in ("t_nsg", "t_hubs", "t_topo", "t_samples", "t_train", "t_nav"):
        assert rep[t] >= 0.0
    true_ids, _ = exact_knn(eq, idx.db, 10, device="cpu")
    sp = SearchParams(k=10, beam_width=32, max_hops=128)
    rec_g = recall_at_k(idx.search(eq, params=sp, device="cpu").ids.numpy(),
                        true_ids, 10)
    rec_b = recall_at_k(
        idx.search_baseline(eq, params=sp, device="cpu").ids.numpy(),
        true_ids, 10)
    assert rec_g >= rec_b - 0.02, (rec_g, rec_b)
    entries = idx.select_entries(eq[:16], device="cpu").numpy()
    assert np.isin(entries, idx.hubs.ids).all()


def test_unported_config_flags_raise():
    """The two ablation flags that raised before they were ported now
    build: ``hop_mode="bfs"`` takes the BFS hop counts (a hub is 0 hops
    from itself) and ``use_hbkm=False`` the k-means hubs (parity with
    ``repro`` is tests/test_torch_build_ablations.py)."""
    rng = np.random.default_rng(0)
    db = rng.standard_normal((24, 4)).astype(np.float32)
    nbrs = np.stack([(np.arange(24) + s) % 24 for s in (1, 2, 5)], axis=1)
    for flag in ({"hop_mode": "bfs"}, {"use_hbkm": False}):
        idx = GateIndex.from_graph(
            db, nbrs.astype(np.int32), 0, db,
            GateConfig(n_hubs=3, epochs=2, batch_hubs=3, subgraph_max_nodes=8,
                       **flag), device="cpu")
        assert idx.hubs.n == 3 and idx.gcfg == GateConfig(
            n_hubs=3, epochs=2, batch_hubs=3, subgraph_max_nodes=8, **flag)
        hops = idx.build_report["samples"]
        assert hops["pos_mean"] > 0
