"""The yardstick by itself: the reference's ground truth and graph checks,
the frozen bound, the trace's reading, the traffic generator, and what the
benchmark's files import."""
import ast
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gatebench import cells, check, traffic
from gatebench.reference import graph, knn
from gatebench.trace import Trace, short_name
from gatebench.yardstick import hop_bound, recall_at_k

BENCH = Path(__file__).resolve().parents[1]


def test_exact_knn_is_numpy_brute_force():
    rng = np.random.default_rng(0)
    db = rng.standard_normal((500, 24)).astype(np.float32)
    q = rng.standard_normal((70, 24)).astype(np.float32)
    d = ((q[:, None, :].astype(np.float64) - db[None]) ** 2).sum(-1)
    want = np.argsort(d, axis=1, kind="stable")[:, :10]
    got = knn.exact_knn(db, q, 10, device="cpu", block=16)
    assert np.array_equal(got, want)
    dist = knn.sq_l2(db, q, np.where(np.arange(10) < 9, got, -1), device="cpu")
    assert np.allclose(dist[:, :9], np.take_along_axis(d, want, 1)[:, :9],
                       rtol=1e-12)
    assert np.isnan(dist[:, 9]).all()


def test_hop_bound_counts_each_distinct_row_once():
    ids = torch.tensor([[3, 3, 5, -1], [5, 7, -1, -1], [-1, -1, -1, -1]],
                       dtype=torch.int32)
    b = hop_bound(torch, ids, row_bytes=512, q_bytes=512, width=128)
    assert b["distinct_rows"] == 3 and b["valid_slots"] == 5
    assert b["active_queries"] == 2
    assert b["bytes"] == ids.numel() * 8 + 3 * 512 + 2 * 512
    assert b["ops"] == 5 * 128 * 3 and b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)


def test_recall_counts_a_repeated_answer_once():
    true = np.array([[1, 2, 3, 4]])
    assert recall_at_k(np.array([[1, 1, 2, 9]]), true, 4) == 0.5
    assert recall_at_k(np.array([[4, 3, 2, 1]]), true, 4) == 1.0


def test_graph_checks():
    nb = np.array([[1, -1], [2, 0], [0, -1], [3, -1], [7, -1]])
    assert graph.bad_edges(nb, 5) == 1
    assert graph.unreachable(nb, 0, device="cpu") == 2   # rows 3 and 4
    nb[2, 1] = 3
    nb[4, 0] = 0
    nb[3, 1] = 4
    assert graph.unreachable(nb, 0, device="cpu") == 0


def test_the_trace_reads_busy_time_and_labels_its_gaps():
    ms = 1_000_000
    ev = [("void rows_f32_bulk<false>(int const*, float*)", 0, 2 * ms),
          ("void at::native::elementwise_kernel<128, 4>(int)", ms, 3 * ms),
          ("void rows_f32_regs(int const*)", 5 * ms, 6 * ms)]
    t = Trace(list(ev), 0, 10 * ms)
    assert t.busy_s == pytest.approx(4e-3) and t.window_s == pytest.approx(1e-2)
    assert t.kernel_s(("rows_f32_bulk", "rows_f32_regs")) == pytest.approx(3e-3)
    gaps = dict(t.idle_gaps([(0, 3 * ms + ms // 2, "in a batch")]))
    assert gaps == {"between: 2 gaps of 1 ms or more": pytest.approx(6e-3)}
    gaps = dict(t.idle_gaps([(0, 4 * ms, "in a batch")]))
    assert gaps == {"in a batch: 1 gaps of 1 ms or more": pytest.approx(2e-3),
                    "between: 1 gaps of 1 ms or more": pytest.approx(4e-3)}
    top = t.top_ops(2)
    assert top[0][0] == "rows_f32_bulk<false>"
    assert short_name("void f<a<b>>(int)") == "f<a<b>>"


def _run(**kw):
    hops = [np.array([2, 4, 4, 6]), np.array([1, 1, 2, 4])]
    answers = [SimpleNamespace(result={"hops": h, "evals": 10 * h,
                                       "ids": np.zeros((4, 10))},
                               due=0.0, done=1.0 + i)
               for i, h in enumerate(hops)]
    window = SimpleNamespace(answers=answers, seconds=2.0, t1=2.0)
    return SimpleNamespace(window=window, mix={},
                           trace=kw.pop("trace", None), bounds_ms=kw.pop(
                               "bounds_ms", {}), build={"nsg_s": 3.0}, **kw)


def _reader(name):
    return cells.load_reader(BENCH / "metrics" / f"{name}.py")


def test_the_readers_read_what_a_run_holds():
    run = _run()
    assert _reader("qps").read(run) == 4.0
    assert _reader("entry.hops_per_query").read(run) == 3.0
    assert _reader("search.evals_per_query").read(run) == 30.0
    assert _reader("search.lockstep_pct").read(run) == pytest.approx(
        100 * 24 / (4 * 6 + 4 * 4))
    assert _reader("build.nsg_s").read(run) == 3.0
    # nothing to read: no trace
    for name in ("k1_roofline", "k2_roofline", "device.idle_pct.batch"):
        assert _reader(name).read(run) is None
    ms = 1_000_000
    trace = Trace([("rows_f32_bulk", 0, 4 * ms)], 0, 10 * ms)
    run = _run(trace=trace, bounds_ms={"gather_rows_dist": 1.0})
    assert _reader("k1_roofline").read(run) == pytest.approx(25.0)
    assert _reader("device.idle_pct.batch").read(run) == pytest.approx(60.0)
    assert _reader("k2_roofline").read(run) is None


@pytest.mark.parametrize("name", ["sift128-250k.batch10k",
                                  "laion512-ood-100k.batch10k"])
def test_every_seed_serves_the_same_queries_in_its_own_order(name):
    cell = cells.find_cell(name)
    cfg = dict(cell.config, rows=2000, train_queries=400)
    mix = dict(cell.mix, batch=50, pool=4)
    db = traffic.database(cfg)
    train, a = traffic.queries(cfg, mix, db, 1)
    train2, b = traffic.queries(cfg, mix, db, 2**31 + 5)
    assert a.shape == b.shape == (4, 50, db.shape[1])
    assert np.array_equal(train, train2)
    assert not np.array_equal(a, b)
    for x, y in zip(a, b):   # batch by batch, the same queries
        rows = [np.sort(z.view(f"V{4 * z.shape[-1]}").ravel()) for z in (x, y)]
        assert np.array_equal(*rows)
    _, c = traffic.queries(cfg, mix, db, 1)
    assert np.array_equal(a, c)
    assert traffic.seeds(2**31 + 5) == traffic.seeds(2**31 + 5)


def test_the_out_of_distribution_pool_is_under_the_logs_transform():
    """The transform is ``make_queries_ood``'s own draw: with no noise its
    queries are the rows it picks under it."""
    from gatebench import data

    db = data.make_database("laion3m-like", 500, seed=0)[0]
    qmat, shift = traffic.ood_transform(db, 40, 3)
    want = data.make_queries_ood(db, 40, seed=3, noise=0.0)
    rows = np.random.default_rng(3).integers(0, len(db), 40)
    assert np.array_equal((db[rows] @ qmat.T + shift).astype(np.float32), want)
    got = traffic.ood_queries(db, 40, 9, (qmat, shift))
    assert got.shape == want.shape and not np.allclose(got, want)


def test_judge_reads_a_limit_as_most_or_least():
    ok, checks = check.judge({"gap": 0.1, "recall": 0.6},
                             {"gap": 0.2, "recall": {"at_least": 0.5}})
    assert ok and checks["recall"]["limit"] == {"at_least": 0.5}
    assert not check.judge({"recall": 0.4}, {"recall": {"at_least": 0.5}})[0]
    assert not check.judge({"gap": 0.3}, {"gap": 0.2})[0]
    assert not check.judge({"new": 0.0}, {})[0]


def test_bad_hubs_counts_repeats_and_strays():
    assert graph.bad_hubs([0, 3, 4], 5) == 0
    assert graph.bad_hubs([0, 3, 3, 5, -1], 5) == 3


def test_the_edge_selection_check_reads_a_built_graph_and_a_random_one():
    """The port's NSG keeps its first R edges by the rule; random edges
    break it."""
    from repro_torch.graphs.nsg import build_nsg

    from gatebench import data

    db = data.make_database("sift10m-like", 1500, seed=0)[0]
    nsg = build_nsg(db, R=12, knn_k=12, search_l=16, pool_size=32,
                    device="cpu")
    rows = np.arange(0, 1500, 3)
    assert graph.prune_violations(db, nsg.neighbors, rows, 12, 6,
                                  device="cpu") == 0.0
    rnd = np.random.default_rng(0).integers(0, 1500, nsg.neighbors.shape)
    assert graph.prune_violations(db, rnd, rows, 12, 6, device="cpu") > 0.5


def test_the_reference_works_out_the_programs_hub_representations():
    """Topology tokens and hub representations, worked out again from the
    graph, the hubs' rows and the tower weights, equal the build's."""
    from repro_torch import GateConfig, GateIndex
    from repro_torch.core.subgraph import sample_all_subgraphs
    from repro_torch.core.topo_embed import embed_all

    from gatebench import system
    from gatebench.reference import topology, walk

    cell = cells.find_cell("sift128-250k.batch10k")
    gate = dict(cell.config["gate"], epochs=4, batch_hubs=8,
                subgraph_max_nodes=32)
    db = traffic.database(dict(cell.config, rows=800))
    train = db[:200] + 0.01
    idx = GateIndex.build(db, train, GateConfig(n_hubs=8, **gate),
                          device="cpu", R=12, knn_k=12, search_l=16,
                          pool_size=32)
    st = system.index_state(idx)
    toks = topology.tokens(db, st["neighbors"], st["hub_ids"], gate)
    want = embed_all(sample_all_subgraphs(
        db, st["neighbors"], st["hub_ids"], h=gate["h"], max_nodes=32,
        seed=gate["seed"]), gate["d_u"], wl_iters=gate["wl_iters"],
        seed=gate["seed"])
    assert np.array_equal(toks != 0, want != 0)
    assert np.allclose(toks, want, rtol=0, atol=1e-6)
    index = check.reference_index(db, st, gate)
    reps = walk.hub_reps(index, "cpu").numpy()
    assert np.allclose(reps, np.asarray(idx.nav.reps), atol=1e-6)
    q = torch.as_tensor(db[:64] + 0.02)
    assert np.array_equal(walk.entries(index, q, torch.float32).numpy(),
                          idx.select_entries(q, device="cpu")[:, 0].numpy())


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") in ("import_module",
                                                      "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")]
    assert not bad
    ref = [(f.name, m) for f in sorted((BENCH / "reference").rglob("*.py"))
           for m in _imports(f)
           if m.split(".")[0] in ("repro_torch", "gatebench")]
    assert not ref
    for f in files:   # nothing reads the JAX package's benchmarks/ folder
        assert "benchmarks/" not in f.read_text() or f.name.startswith("test_")
