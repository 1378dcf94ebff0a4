"""Phase 15 of ``chip_smoke.py`` (the partitioned index on 4 ranks),
rehearsed on the CPU at a tiny size: 2000 sift10m-like rows in 4 shards of
500, a tower drawn from a CPU generator and 32 random hubs (the card run
takes phase 4's), 32 queries, beam 16 and 16 hops, the data-parallel step
at 4 x 16.  Every gate raises as on the card; what the phase returns is
checked here for shape and consistency, not for time."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.twotower import TwoTowerConfig, init_params, query_tower
from repro_torch.data.synthetic import make_database, make_queries_in_dist
from repro_torch.graphs.knn import exact_knn

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def test_partition_phase_rehearsal():
    db, _ = make_database("sift10m-like", 2000, seed=0)
    tcfg = TwoTowerConfig(d_p=db.shape[1])
    params = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    hub_ids = np.random.default_rng(1).choice(len(db), 32, replace=False)
    with torch.no_grad():
        reps = query_tower(params, tcfg, torch.from_numpy(db[hub_ids])).numpy()
    q = make_queries_in_dist(db, 32, seed=9)
    gt, _ = exact_knn(q, db, 10, device="cpu")
    out = chip_smoke.partition_phase(
        torch, np, db, (tcfg, params.as_dict()), (hub_ids, reps), q, gt,
        torch.device("cpu"), knobs=dict(beam_width=16, max_hops=16, k=10),
        train_shape=(4, 16))
    assert out["ranks"] == 4 and out["rows_per_rank"] == 500
    assert 0.0 <= out["recall_at_10"] <= 1.0 and out["qps"] > 0
    assert len(out["step_s"]) == 4 and all(len(s) == 3 for s in out["step_s"])
    assert 0.0 < out["merge_share"] < 1.0
    assert out["mean_hops"] == [16.0] * 4
    assert out["small_cut"] == {"id_agreement": 1.0, "dist_rel": 0.0}
    assert out["cross_pod_max_err"] <= 0.02
    assert out["train"]["loss_rel"] <= 1e-6
    assert out["train"]["params_max_excess_over_tol"] <= 0.0
    assert out["search_peak_bytes"] == [None] * 4  # no card, no number
    assert all(set(st) == {"start", "torch_and_group", "mesh",
                           "shard_and_graph", "searches_and_merges",
                           "small_cut", "cross_pod", "train"}
               for st in out["stage_s"])


def _rank(shard, ids, dists):
    return {"shard": shard, "ids": ids, "dists": dists, "merge_equal": True,
            "small": {"dev": (ids, dists), "cpu": (ids, dists)},
            "cross_pod": np.full(8, 0.5, np.float32),
            "train_dp": (1.0, {"w": np.zeros(2)}),
            "train_single": (1.0, {"w": np.zeros(2)}),
            "step_s": [1.0], "merge_s": [0.1], "mean_hops": 1.0,
            "graph_build_s": 1.0, "transport": "cpu", "stage_s": {}}


def test_partition_gates_raise():
    ids = np.array([[0, 1, 2]], np.int32)
    d = np.array([[0.0, 1.0, 2.0]], np.float32)
    ranks = [_rank(p, ids, d) for p in range(4)]
    out = chip_smoke._partition_gates(np, ranks, ids, d, 10, None)
    assert out["recall_at_10"] is None and out["merge_share"] == 0.1
    with pytest.raises(RuntimeError, match="composition"):
        chip_smoke._partition_gates(np, ranks, ids[:, ::-1].copy(), d, 10,
                                    None)
    ranks[2] = _rank(2, ids[:, ::-1].copy(), d)
    with pytest.raises(RuntimeError, match="rank 2"):
        chip_smoke._partition_gates(np, ranks, ids, d, 10, None)
    ranks[2] = _rank(2, ids, d)
    ranks[3]["cross_pod"] = np.full(8, 0.6, np.float32)
    with pytest.raises(RuntimeError, match="cross_pod"):
        chip_smoke._partition_gates(np, ranks, ids, d, 10, None)
