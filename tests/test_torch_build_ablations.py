"""The build's ablation paths against ``repro``'s, on the CPU: the BFS hop
counts (``GateConfig(hop_mode="bfs")``), the plain k-means hubs
(``use_hbkm=False``, the paper's "GATE w/o H") and greedy HBKM.

Tolerances: ``hop_counts`` equal (host numpy in both packages); hub ids and
assignments equal, centroids within 1e-5 (fp32 sums in another order);
greedy assignments equal.  An index built under each flag uses the same
hubs and the same samples as ``repro``'s, and passes the quality checks
tests/test_torch_gate_index.py holds the default build to.
"""
import importlib

import numpy as np
import pytest

from repro.core import GateConfig as JConfig
from repro.core import GateIndex as JIndex
from repro.core.hubs import kmeans_hubs as j_kmeans_hubs
from repro.core.samples import hop_counts as j_hop_counts
from repro.data.synthetic import make_database, train_eval_query_split
from repro.graphs.nsg import build_nsg

from repro_torch import GateConfig, GateIndex, SearchParams, exact_knn, recall_at_k
from repro_torch.core.hubs import kmeans_hubs
from repro_torch.core.samples import _reverse_csr, hop_counts, top1_targets

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

j_hbkm = importlib.import_module("repro.core.hbkm")
t_hbkm = importlib.import_module("repro_torch.core.hbkm")
CPU = "cpu"


@pytest.fixture(scope="module")
def graph():
    db, _ = make_database("sift10m-like", 800, seed=4)
    nsg = build_nsg(db, R=12, knn_k=12, search_l=16, pool_size=32)
    tq, eq = train_eval_query_split(db, 128, 48)
    return db, nsg, tq, eq


def test_hop_counts_equal(graph):
    db, nsg, tq, _ = graph
    targets = top1_targets(db, tq, device=CPU)
    hubs = np.arange(0, 800, 61)
    for max_hops in (64, 3):
        got = hop_counts(nsg.neighbors, targets, hubs, max_hops=max_hops)
        want = j_hop_counts(nsg.neighbors, targets, hubs, max_hops=max_hops)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    indptr, rev = _reverse_csr(nsg.neighbors)
    assert indptr[-1] == (nsg.neighbors >= 0).sum() == len(rev)
    # line graph 0→1→2→3 and an unreachable hub, as tests/test_gate_core.py
    nbrs = np.array([[1], [2], [3], [-1], [-1]], np.int32)
    for t, hubs in ((np.array([3]), np.array([0, 1, 3])),
                    (np.array([3, 3, 0]), np.array([4, 2]))):
        np.testing.assert_array_equal(hop_counts(nbrs, t, hubs, max_hops=9),
                                      j_hop_counts(nbrs, t, hubs, max_hops=9))


def test_kmeans_hubs_equal(graph):
    db = graph[0]
    for n_c, seed in ((12, 0), (7, 3)):
        got = kmeans_hubs(db, n_c, seed=seed, device=CPU)
        want = j_kmeans_hubs(db, n_c, seed=seed)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.assign, want.assign)
        np.testing.assert_allclose(got.centroids, want.centroids,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,lam,seed", [(2, 1.0, 0), (8, 1.0, 3), (5, 4.0, 1)])
def test_greedy_balanced_kmeans_equal(graph, k, lam, seed):
    db = graph[0]
    got, gc = t_hbkm.balanced_kmeans(db, k, lam=lam, seed=seed, mode="greedy",
                                     device=CPU)
    want, wc = j_hbkm.balanced_kmeans(db, k, lam=lam, seed=seed, mode="greedy")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(gc, wc, rtol=1e-5, atol=1e-5)


def test_greedy_hbkm_equal(graph):
    db = graph[0]
    got, gc = t_hbkm.hbkm(db, 16, mode="greedy", device=CPU)
    want, wc = j_hbkm.hbkm(db, 16, mode="greedy")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(gc, wc, rtol=1e-5, atol=1e-5)
    # the paper's balance objective: greedy beats the unpenalized split
    plain, _ = t_hbkm.balanced_kmeans(db, 8, lam=0.0, device=CPU)
    greedy, _ = t_hbkm.balanced_kmeans(db, 8, lam=1.0, mode="greedy",
                                       device=CPU)
    assert (t_hbkm.cluster_size_variance(greedy, 8)
            < t_hbkm.cluster_size_variance(plain, 8))


FLAGS = [{"use_hbkm": False}, {"hop_mode": "bfs"}]


@pytest.mark.parametrize("flag", FLAGS)
def test_ablation_builds_match_repro(graph, flag):
    """``from_graph`` under each flag takes ``repro``'s hubs and samples."""
    db, nsg, tq, eq = graph
    kw = dict(n_hubs=12, epochs=10, batch_hubs=12, subgraph_max_nodes=32,
              **flag)
    jidx = JIndex.from_graph(db, nsg.neighbors, nsg.enter_id, tq, JConfig(**kw))
    idx = GateIndex.from_graph(db, nsg.neighbors, nsg.enter_id, tq,
                               GateConfig(**kw), device=CPU)
    np.testing.assert_array_equal(idx.hubs.ids, jidx.hubs.ids)
    np.testing.assert_array_equal(idx.hubs.assign, jidx.hubs.assign)
    assert idx.build_report["samples"] == jidx.build_report["samples"]
    res = idx.search(eq, params=SearchParams(k=5, beam_width=16, max_hops=64),
                     device=CPU)
    assert tuple(res.ids.shape) == (len(eq), 5) and bool((res.ids >= 0).all())


@pytest.mark.parametrize("flag", FLAGS)
def test_ablation_builds_pass_quality(small_db, small_nsg, flag):
    """On the graph and config tests/test_torch_gate_index.py builds the
    default index with (2000 rows, R = 32, 48 hubs): training lowers the
    loss, every hub has a positive, and GATE's recall@10 is within 0.02 of
    the medoid baseline's or better."""
    db, nsg = small_db[0], small_nsg
    tq, eq = train_eval_query_split(db, 384, 96)
    idx = GateIndex.from_graph(
        db, nsg.neighbors, nsg.enter_id, tq,
        GateConfig(n_hubs=48, epochs=60, batch_hubs=48, subgraph_max_nodes=64,
                   **flag), device=CPU)
    rep = idx.build_report
    assert rep["loss_last"] < rep["loss_first"]
    assert rep["samples"]["hub_with_no_pos"] == 0
    for t in ("t_hubs", "t_topo", "t_samples", "t_train", "t_nav"):
        assert rep[t] >= 0.0
    true_ids, _ = exact_knn(eq, db, 10, device=CPU)
    sp = SearchParams(k=10, beam_width=32, max_hops=128)
    rec_g = recall_at_k(idx.search(eq, params=sp, device=CPU).ids.numpy(),
                        true_ids, 10)
    rec_b = recall_at_k(
        idx.search_baseline(eq, params=sp, device=CPU).ids.numpy(), true_ids, 10)
    assert rec_g >= rec_b - 0.02, (rec_g, rec_b)
