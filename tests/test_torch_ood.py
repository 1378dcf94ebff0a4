"""The port on out-of-distribution queries (the paper's Fig. 6 workload).

1. Data: for each of the paper's five Table-2 profiles, the database, the
   in-distribution and OOD query makers and ``train_eval_query_split`` with
   a 50/50 in/out mix (21 evaluation queries: an uneven split) give
   ``repro``'s bits.
2. OOD samples at d = 200: ``top1_targets``, ``greedy_hops`` and
   ``make_samples`` on a mixed log over ``repro``'s NSG equal ``repro``'s,
   as tests/test_torch_build.py holds them on in-distribution queries.
3. An index the port builds on the CPU (2,000 rows of text2image10m-like
   on a 50/50 log) passes bench_ood's quality checks: the loss falls, every
   hub has a positive, and GATE's recall@10 is at least the medoid's - 0.02
   at beam 32 on each query type.
4. Phase 18 of ``chip_smoke.py`` rehearsed on the CPU at a cut size, with
   the CUDA-event timer stubbed out (as tests/test_torch_hop_phase.py
   rehearses the hop phase), and its record in the kernels line.
"""
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import synthetic as j_syn
from repro.graphs.nsg import build_nsg as j_build_nsg

from repro_torch import GateConfig, GateIndex, SearchParams, exact_knn, recall_at_k
from repro_torch.core import samples as t_samples
from repro_torch.data import synthetic as t_syn

from test_torch_kernel_phase import rehearsal  # noqa: F401  (fixture)
from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

j_samples = importlib.import_module("repro.core.samples")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

CPU = "cpu"


def test_profiles_match():
    assert set(t_syn.PROFILES) == set(j_syn.PROFILES)
    for name, p in j_syn.PROFILES.items():
        assert t_syn.PROFILES[name].__dict__ == p.__dict__


@pytest.mark.parametrize("profile", sorted(j_syn.PROFILES))
def test_query_makers_bit_equal(profile):
    db_j, assign_j = j_syn.make_database(profile, 300, seed=3)
    db_t, assign_t = t_syn.make_database(profile, 300, seed=3)
    np.testing.assert_array_equal(db_t, db_j)
    np.testing.assert_array_equal(assign_t, assign_j)
    for maker in ("make_queries_in_dist", "make_queries_ood"):
        want = getattr(j_syn, maker)(db_j, 40, seed=17)
        got = getattr(t_syn, maker)(db_t, 40, seed=17)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=maker)
    want = j_syn.train_eval_query_split(db_j, 50, 21, seed=1, ood_fraction=0.5)
    got = t_syn.train_eval_query_split(db_t, 50, 21, seed=1, ood_fraction=0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def mixed_log():
    """1,000 rows of text2image10m-like, ``repro``'s NSG over them and the
    training half of a 50/50 in/out split."""
    db, _ = j_syn.make_database("text2image10m-like", 1000, seed=1)
    nsg = j_build_nsg(db, R=16, knn_k=16, search_l=32, pool_size=48)
    train_q, _ = j_syn.train_eval_query_split(db, 64, 16, seed=1,
                                              ood_fraction=0.5)
    return db, nsg, train_q


@pytest.mark.parametrize("queries", ["mixed_log", "ood_only"])
def test_ood_samples_exact(mixed_log, queries):
    db, nsg, train_q = mixed_log
    q = train_q if queries == "mixed_log" else j_syn.make_queries_ood(
        db, 40, seed=5)
    hub_ids = np.arange(0, 1000, 53)
    tgt = t_samples.top1_targets(db, q, device=CPU)
    np.testing.assert_array_equal(tgt, j_samples.top1_targets(db, q))
    hj = j_samples.greedy_hops(db, nsg.neighbors, q, hub_ids, tgt,
                               beam_width=8, max_hops=24)
    ht = t_samples.greedy_hops(db, nsg.neighbors, q, hub_ids, tgt,
                               beam_width=8, max_hops=24, chunk=300,
                               device=CPU)
    np.testing.assert_array_equal(ht, hj)
    sa = j_samples.make_samples(hj, t_pos=2, t_neg=6)
    sb = t_samples.make_samples(ht, t_pos=2, t_neg=6)
    for x, y in zip(sa.pos + sa.neg, sb.pos + sb.neg):
        np.testing.assert_array_equal(y, x)
    assert sa.stats() == sb.stats()


@pytest.fixture(scope="module")
def port_built_ood():
    db, _ = t_syn.make_database("text2image10m-like", 2000, seed=0)
    train_q, _ = t_syn.train_eval_query_split(db, 384, 96, seed=1,
                                              ood_fraction=0.5)
    gcfg = GateConfig(n_hubs=48, epochs=60, batch_hubs=48, subgraph_max_nodes=64)
    idx = GateIndex.build(db, train_q, gcfg, R=32, knn_k=32, search_l=64,
                          pool_size=96, device=CPU)
    queries = {"in_dist": t_syn.make_queries_in_dist(db, 200, seed=17),
               "ood": t_syn.make_queries_ood(db, 200, seed=17)}
    return idx, queries


def test_port_built_ood_index_trains(port_built_ood):
    idx, _ = port_built_ood
    rep = idx.build_report
    assert rep["loss_last"] < rep["loss_first"]
    assert rep["samples"]["hub_with_no_pos"] == 0
    assert idx.db.shape[1] == 200 and idx.tower_cfg.d_p == 200


@pytest.mark.parametrize("qtype", ["in_dist", "ood"])
def test_port_built_ood_index_beats_the_medoid(port_built_ood, qtype):
    idx, queries = port_built_ood
    q = queries[qtype]
    true_ids, _ = exact_knn(q, idx.db, 10, device=CPU)
    sp = SearchParams(k=10, beam_width=32, max_hops=max(4 * 32, 64),
                      kernel="fused")
    rec_g = recall_at_k(idx.search(q, params=sp, device=CPU).ids.numpy(),
                        true_ids, 10)
    rec_b = recall_at_k(
        idx.search_baseline(q, params=sp, entry="medoid",
                            device=CPU).ids.numpy(), true_ids, 10)
    assert rec_g >= rec_b - 0.02, (rec_g, rec_b)


def test_ood_phase_rehearsal(monkeypatch):
    """Phase 18 on the CPU at a cut size (600 rows of laion3m-like, an
    80-query log, 8 hubs, beams 8 and 64; the widths at 300 rows and (1024,
    20) ids), the timer stubbed: its gates run, the launch counts are read,
    the recorded OOD calls and the widths are held at 0.0, each width's
    bound reads each distinct row once (at most 300 of ~18,000 valid
    slots), and the ring's rows, which only the card's library reports,
    are None."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cuda_times",
                        lambda torch, fn, reps: [fn(i) is None or 0.0
                                                 for i in range(reps)])
    out = chip_smoke.ood_phase(
        torch, np, CPU, n=600, n_train=80, n_eval=40,
        gcfg=GateConfig(n_hubs=8, epochs=20, batch_hubs=8,
                        subgraph_max_nodes=32),
        nsg_kw=dict(R=16, knn_k=16, search_l=32, pool_size=48),
        beams=(8, 64), width_kw=dict(rows=300, R=20, reps=3),
        check_every=3, n_plain=2)
    assert out["d"] == 512 and out["train_queries"] == 80
    for qtype in ("in_dist", "ood"):
        rec = out["types"][qtype]
        assert [r["beam_width"] for r in rec["sweep"]["GATE"]] == [8, 64]
        assert set(rec["kernels_at_64"]) == {"xla", "fused", "fused_q8"}
        assert rec["fused_vs_xla"] == 1.0
        for r in rec["sweep"]["GATE"] + rec["sweep"]["medoid"]:
            assert {"recall_at_10", "qps", "mean_hops", "mean_dist_evals",
                    "mean_entry_rank_proxy"} <= set(r)
    # CPU tensors take the plain versions, which count no launch
    assert set(out["launches"]) >= {"gather_rows_dist", "gather_rows_dist_q8",
                                    "twotower_score"}
    assert out["build"]["padded_R"] == out["hop"]["fused_l2"]["R"]
    assert set(out["hop"]) == {"fused_l2", "fused_q8_l2"}
    assert out["hop"]["fused_q8_l2"]["width"] == 512
    assert "gap_at_64" in out
    assert set(out["widths"]) == {"text2image10m-like", "tiny5m-like",
                                  "gist1m-like"}
    for profile, w in out["widths"].items():
        for name in ("gather_rows_dist", "gather_rows_dist_q8"):
            for metric in ("l2", "cosine"):
                m = w[name][metric]
                assert m["max_abs_err"] == 0.0
                assert m["ring_rows"] is None
                assert m["bound_ms"] > 0
                assert m["distinct_rows"] <= 300 < 15_000 < m["valid_slots"]


def test_kernels_line_carries_phase_18(rehearsal):
    """Phase 18's record in the kernels line: K1-K3 add its launches, K1
    and K2 carry its OOD calls and every width, and their max abs error
    is the largest of all their holds."""
    db, queries = rehearsal
    kres = chip_smoke.kernel_phase(torch, np, db, queries, "cpu", n_sm=132)
    api = chip_smoke.api_phase(torch, np, db, queries, "cpu", reps=2)
    hop = {label: {"kernel": {"ms_median": 1.0, "max_abs_err": 0.0,
                              "ms_sum": 9.0},
                   "plain_ms_median": 2.0, "bound_ms_median": 0.5,
                   "bound_by": "bytes", "B": 90, "R": 247}
           for label in ("fused_l2", "fused_q8_l2")}
    counts = dict.fromkeys(chip_smoke.SOURCES, 3)
    single = {"shape": [1, 247], "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.1,
              "bound_by": "bytes", "max_abs_err": 0.0}
    greedy = {lbl: {"shape": [n, 8], "ms": 1.0, "plain_ms": 9.0,
                    "library_ms": None, "bound_ms": 0.01, "bound_by": "bytes",
                    "max_abs_err": 0.0}
              for lbl, n in (("slice", 300), ("root_split", 900))}

    def metric(err, ring):
        return {"ms": 0.1, "plain_ms": 0.3, "bound_ms": 0.05,
                "bound_by": "bytes", "ring_rows": ring, "max_abs_err": err}

    widths = {p: {"d": d, "gather_rows_dist": {"l2": metric(0.0, r1),
                                               "cosine": metric(err, r1)},
                  "gather_rows_dist_q8": {"l2": metric(0.0, r2),
                                          "cosine": metric(0.0, r2)}}
              for p, d, r1, r2, err in (("text2image10m-like", 200, 20, 32, 0.0),
                                        ("gist1m-like", 960, 4, 16, 2.5e-7))}
    ood = {"launches": dict.fromkeys(chip_smoke.SOURCES, 2), "d": 512,
           "hop": {label: {**h, "B": 5000} for label, h in hop.items()},
           "widths": widths}
    line = chip_smoke.kernels_line(kres, api, hop, counts, counts, counts,
                                   single, greedy, counts, counts, ood=ood)
    json.dumps({"kernels": line})
    by = {e["name"]: e for e in line}
    for name in ("gather_rows_dist", "gather_rows_dist_q8", "twotower_score"):
        assert by[name]["launches_by_path"]["ood"] == 2
        assert by[name]["launches"] == sum(by[name]["launches_by_path"].values())
    assert "ood" not in by["topk_min"]["launches_by_path"]
    for name in ("gather_rows_dist", "gather_rows_dist_q8"):
        e = by[name]
        assert e["ood_shape"]["shape"] == [5000, 247] and e["ood_shape"]["d"] == 512
        assert set(e["widths"]) == {"200", "960"}
    assert by["gather_rows_dist"]["widths"]["960"]["cosine"]["ring_rows"] == 4
    assert by["gather_rows_dist"]["max_abs_err"] == 2.5e-7
    assert by["gather_rows_dist_q8"]["max_abs_err"] == 0.0
