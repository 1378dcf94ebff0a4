"""The feedback phase of ``chip_smoke.py`` (phase 9), rehearsed on the CPU.

``feedback_phase`` runs here on ``repro``'s 400-row serving fixture carried
across (``pair`` of ``tests/test_torch_serve.py``), with ``dev="cpu"`` (the
kernel wrappers run their plain versions), ``torch.cuda.synchronize`` and
the CUDA-event timer stubbed out, and small sizes: a query log of 4 routed
batches of 16 from a port daemon that shadow-labels every batch, then 3
requests of 16 to the learned daemon, 24 evaluation queries and 3
single-query searches.  Every check of the phase runs as on the card; what
it returns is checked here for shape and consistency, not for time.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.obs import DEFAULT_LADDER
from repro_torch.serve.daemon import ServeDaemon

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)
from test_torch_serve import _queries, pair  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def test_feedback_phase_rehearsal(pair, tmp_path, monkeypatch):  # noqa: F811
    _, tidx = pair
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cuda_times",
                        lambda torch, fn, reps: [fn(i) is None or 1.0
                                                 for i in range(reps)])
    obs.get_registry().reset()
    qlog = tmp_path / "qlog.jsonl"
    daemon = ServeDaemon(tidx, ladder=DEFAULT_LADDER, route=True,
                         kernel="fused", batch_size=16, qlog=str(qlog),
                         shadow_every=1, device="cpu")
    daemon.start()
    try:
        for i in range(4):
            daemon.search(_queries(tidx, 16, seed=40 + i))
    finally:
        daemon.stop()
    formula = {"latency_p50_s": 0.1, "latency_p99_s": 0.2, "qps": 100.0,
               "hard_frac_path": [0.25] * 4, "hard_queries": [4] * 4}

    fb = chip_smoke.feedback_phase(
        torch, np, tidx, _queries(tidx, 24, seed=50), _queries(tidx, 48, seed=51),
        "cpu", str(qlog), formula, n_req=3, batch=16, n_single=3,
        work_dir=tmp_path / "build")
    assert fb["log"]["labeled"] == 64
    assert fb["fit"]["metrics"]["examples"] == 64
    sl = fb["serve_learned"]
    assert sl["reload"]["version"] == 1 and sl["reload"]["jit_cache_growth"] == 0
    assert len(sl["latency_s"]) == 3 and len(sl["hard_frac_path"]) == 4
    assert sl["formula"] == formula
    assert fb["persist"]["bytes"] > tidx.db.nbytes
    assert fb["persist"]["bit_equal"] == ["fused", "fused_q8"]
    assert list((tmp_path / "build").iterdir()) == []  # the saved copy is gone
    assert fb["single"]["queries"] == 3

    single = chip_smoke.single_query_k1(torch, np, fb.pop("single_calls"), "cpu")
    assert single["shape"] == [1, tidx.neighbors.shape[1]]
    assert single["calls"] > 3 and single["max_abs_err"] == 0.0
    assert single["ms"] == single["plain_ms"] == 1.0
    assert single["bound_by"] in ("bytes", "operations")

    # a log with too few labels is refused before anything is fitted
    with pytest.raises(RuntimeError, match="labeled queries"):
        chip_smoke.feedback_phase(
            torch, np, tidx, None, None, "cpu", str(qlog), formula,
            min_labeled=1000, work_dir=tmp_path / "build")
