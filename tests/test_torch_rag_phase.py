"""Phases 10, 11, 12 and 13 of ``chip_smoke.py`` (the build's ablation
paths and the entry baselines; RAG serving with a dense, an MoE and the
recurrent decoders), rehearsed on the CPU.

The phases run on ``repro``'s 400-row serving fixture carried across
(``pair`` of ``tests/test_torch_serve.py``) with ``dev="cpu"`` (the kernel
wrappers run their plain versions), ``torch.cuda.synchronize``, the
CUDA-event timer and the device profiler stubbed out, and small sizes: 40
evaluation queries, the BFS build on a fresh 200-row database, 8 HBKM
leaves, and the reduced gemma-2b, then the reduced qwen2-moe-a2.7b (with
the reduced internvl2-26b for the patch-prefix check), each serving 3
requests of 4 queries, and the reduced zamba2-1.2b and rwkv6-1.6b, each
serving 2.  Every check of the phases runs as on
the card; what they return is checked here for shape and consistency,
not for time.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import exact_knn, obs
from repro_torch.configs import get_reduced

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)
from test_torch_serve import _queries, pair  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def _stub(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(chip_smoke, "cuda_times",
                        lambda torch, fn, reps: [fn(i) is None or 1.0
                                                 for i in range(reps)])
    # the profiler records device activity only, which a CPU build lacks:
    # the stub runs the call and reports no device time
    monkeypatch.setattr(chip_smoke, "profile_call",
                        lambda torch, fn, wall_s: fn() or {
                            "wall_s": wall_s, "device_busy_s": None,
                            "kernel_launches": 0})


def test_bfs_timing_runs_in_a_process_of_its_own(pair):  # noqa: F811
    """The full-size bfs projection: hop_counts timed on the first unique
    targets of the index's graph in a spawned pool, as main() runs it
    beside phases 10-11."""
    import multiprocessing

    _, tidx = pair
    train_q = _queries(tidx, 64, seed=61)
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        job, n_uniq = chip_smoke.start_bfs_timing(torch, np, pool, tidx,
                                                  train_q, "cpu", n=5)
        proj = chip_smoke.bfs_projection(job.get(timeout=120), n_uniq)
    assert 5 <= n_uniq <= 64 and proj["targets_timed"] == 5
    assert proj["csr_s"] > 0 and proj["s_per_target"] >= 0
    assert proj["projected_s"] == proj["csr_s"] + n_uniq * proj["s_per_target"]


def test_ablation_phase_rehearsal(pair, monkeypatch):  # noqa: F811
    _, tidx = pair
    _stub(monkeypatch)
    eval_q = _queries(tidx, 40, seed=60)
    train_q = _queries(tidx, 64, seed=61)
    gt, _ = exact_knn(eval_q, tidx.db, 10, device="cpu")
    l2 = chip_smoke.search_phase(torch, tidx, eval_q, gt, "l2", ("fused",),
                                 baseline=True, dev="cpu")
    abl = chip_smoke.ablation_phase(
        torch, np, tidx, tidx.db, train_q, eval_q, gt, l2, "cpu",
        bfs_n=200, n_leaves=8)
    assert list(abl["entries"]) == ["GATE", "medoid", "random", "kmtree", "hash"]
    for name, row in abl["entries"].items():
        assert 0.0 <= row["recall_at_10"] <= 1.0 and row["mean_hops"] > 0
    assert abl["entries"]["GATE"]["recall_at_10"] == \
        l2["gate/fused"]["recall_at_10"]
    assert 8 < abl["entry_build"]["kmtree_leaves"] <= 64  # 8 x 8, less empty
    wo = abl["without_hbkm"]
    assert wo["build_s"] >= wo["stages_s"] > 0 and 0 <= wo["recall_at_10"] <= 1
    assert wo["default"]["recall_at_10"] == l2["gate/fused"]["recall_at_10"]
    bfs = abl["bfs"]
    assert bfs["n"] == 200
    assert bfs["samples"]["hub_with_no_pos"] >= 0 and bfs["nsg_s"] > 0
    assert set(bfs["default"]) >= {"build_s", "recall_at_10", "qps"}
    for mode in ("batch", "greedy"):
        assert abl["hbkm"][mode]["cluster_size_variance"] >= 0
        lo, hi = abl["hbkm"][mode]["sizes_min_max"]
        assert 1 <= lo <= hi

    greedy = chip_smoke.greedy_record(torch, np, tidx.db, "cpu", rows=300)
    assert greedy["slice"]["shape"] == [300, 8]
    assert greedy["slice"]["max_abs_err"] == 0.0
    assert greedy["slice"]["bytes"] == 300 * 8 * 4 + 300 * 4
    assert greedy["root_split"]["shape"] == [400, 8]


def test_rag_phase_rehearsal(pair, monkeypatch):  # noqa: F811
    _, tidx = pair
    _stub(monkeypatch)
    obs.get_registry().reset()
    cfg = get_reduced("gemma-2b")
    rag = chip_smoke.rag_phase(torch, np, tidx, _queries(tidx, 12, seed=70),
                               "cpu", n_req=3, batch=4, prompt_len=8,
                               doc_len=4, new=3, cfg=cfg)
    assert rag["context_len"] == 4 * 4 + 8
    c = rag["checks"]
    assert c["prefill_decode_rel_err"] <= 1e-3 and c["attention_rel_err"] <= 1e-4
    assert c["prefill_decode_rel_err_f64"] <= 1e-12
    assert c["layer_decode_rel_err"] <= 1e-3
    sv = rag["serve"]
    assert len(sv["latency_s"]) == 3 and sv["tokens"] == 3 * 4 * 3
    assert sv["span_seconds"]["prefill"] > 0 and sv["span_seconds"]["decode"] > 0
    assert sv["span_seconds"]["retrieve"] > 0
    assert rag["resident_bytes"]["params"] > 0
    prof = rag["profile_request"]  # the stub: no device time on the CPU
    assert prof["wall_s"] > 0 and prof["device_busy_s"] is None
    # reduced configs compute in float32: the compute copy is the params
    assert rag["resident_bytes"]["compute_copy"] == 0
    assert chip_smoke.check_rag(torch, np, tidx, rag.pop("check"), "cpu") == 3
    assert not obs.get_tracer().enabled


def test_moe_rag_phase_rehearsal(pair, monkeypatch):  # noqa: F811
    _, tidx = pair
    _stub(monkeypatch)
    obs.get_registry().reset()
    cfg = get_reduced("qwen2-moe-a2.7b")
    rag = chip_smoke.moe_rag_phase(
        torch, np, tidx, _queries(tidx, 12, seed=71), "cpu", n_req=3,
        batch=4, prompt_len=8, doc_len=4, new=3, cfg=cfg,
        vlm_cfg=get_reduced("internvl2-26b"))
    assert rag["context_len"] == 4 * 4 + 8
    assert rag["experts"] == [4, 2, 1] and rag["impl"] == "dense"
    assert 0 < rag["active_params"] < rag["params"]
    c = rag["checks"]
    assert c["router_ties_lowest_first"] and c["greedy_repeatable"]
    assert c["prefill_decode_rel_err_f64"] <= 1e-12
    assert c["dropping_vs_dense_rel_err_f64"] <= 1e-12
    assert c["layer_decode_rel_err_f32"] <= 1e-3
    assert c["dropped_share_cf_2"] == 0.0  # E/K = 4/2: nothing dropped
    assert 0.0 <= c["dropped_share_cf_1.25"] < 1.0
    vlm = rag["vlm"]
    assert vlm["patches"] == [8, 64] and vlm["layers"] == 2
    assert vlm["prefill_decode_rel_err_f64"] <= 1e-12
    sv = rag["serve"]
    assert len(sv["latency_s"]) == 3 and sv["tokens"] == 3 * 4 * 3
    assert sv["span_seconds"]["prefill"] > 0 and sv["span_seconds"]["decode"] > 0
    # reduced configs compute in float32: the parameters are the weights
    assert rag["resident_bytes"]["compute_copy"] == 0
    step = rag["decode_step"]
    assert step["ms"] > 0 and step["prefill_s_per_request"] > 0
    assert 0 < step["active_bytes"] < step["all_bytes"] == \
        rag["resident_bytes"]["total"]
    assert step["bound_ms_active_bytes"] < step["bound_ms_dense_all_bytes"]
    assert chip_smoke.check_rag(torch, np, tidx, rag.pop("check"), "cpu") == 3
    assert not obs.get_tracer().enabled


def test_recurrent_rag_phase_rehearsal(pair, monkeypatch):  # noqa: F811
    """Phase 13 with the reduced zamba2-1.2b and rwkv6-1.6b, 2 requests of
    4 queries each: 40-token contexts, so the float64 checks' 41 tokens
    run 2 SSD chunks of 32 and 3 WKV chunks of 16, each with a padded
    tail."""
    _, tidx = pair
    _stub(monkeypatch)
    obs.get_registry().reset()
    cfgs = [get_reduced("zamba2-1.2b"), get_reduced("rwkv6-1.6b")]
    rag = chip_smoke.recurrent_rag_phase(
        torch, np, tidx, _queries(tidx, 8, seed=72), "cpu", n_req=2,
        batch=4, prompt_len=8, doc_len=8, new=3, cfgs=cfgs)
    checks = rag.pop("check")
    assert len(checks) == 2 and rag["seconds"] > 0
    for cfg in cfgs:
        r = rag[cfg.name]
        assert r["family"] == cfg.family and r["context_len"] == 4 * 8 + 8
        c = r["checks"]
        assert c["finite"] and c["greedy_repeatable"]
        assert c["prefill_decode_rel_err_64"] <= 1e-12
        assert c["prefill_decode_rel_err_32"] <= 1e-4
        sc = c["scan"]
        assert sc["shape"] == [2, 41]
        assert sc["chunks"] == (2 if cfg.family == "hybrid" else 3)
        assert sc["output_rel_err"] <= 1e-12 and sc["state_rel_err"] <= 1e-12
        sv = r["serve"]
        assert len(sv["latency_s"]) == 2 and sv["tokens"] == 2 * 4 * 3
        assert sv["span_seconds"]["prefill"] > 0
        step = r["decode_step"]
        assert step["ms"] > 0 and step["bound_by"] == "bytes"
        # reduced configs compute in float32: the weights are the params
        assert step["weight_bytes"] < r["resident_bytes"]["params"]
        assert step["bytes"] == (step["weight_bytes"] + 2 * step["state_bytes"]
                                 + step["kv_bytes"])
        assert (step["kv_bytes"] > 0) == (cfg.family == "hybrid")
    for c in checks:
        assert chip_smoke.check_rag(torch, np, tidx, c, "cpu") == 2
    assert not obs.get_tracer().enabled


def test_moe_rag_phase_fails_over_its_weight_budget(pair, monkeypatch):  # noqa: F811
    _, tidx = pair
    _stub(monkeypatch)
    with pytest.raises(RuntimeError, match="weight bytes resident"):
        chip_smoke.moe_rag_phase(
            torch, np, tidx, _queries(tidx, 12, seed=71), "cpu", n_req=1,
            batch=4, prompt_len=8, doc_len=4, new=2,
            cfg=get_reduced("qwen2-moe-a2.7b"),
            vlm_cfg=get_reduced("internvl2-26b"), max_weight_bytes=1e5)


def test_layerwise_decode_check_sees_a_broken_cache():
    """The layer-by-layer check is 0-ish on the real decode and large when
    the decode reads a cache that is not the prefill's."""
    from repro_torch.models.model import build_model

    cfg = get_reduced("llama3-8b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (2, 30)).astype(np.int32))
    assert chip_smoke.layerwise_decode_check(torch, model, params, toks) < 1e-5

    class Shifted(type(model)):
        def _cache_from_prefill(self, ks, vs, pos, S, capacity=None):
            c = super()._cache_from_prefill(ks, vs, pos, S, capacity)
            return {**c, "v": torch.roll(c["v"], 1, dims=2)}

    bad = Shifted(cfg)
    assert chip_smoke.layerwise_decode_check(torch, bad, params, toks) > 1e-2
