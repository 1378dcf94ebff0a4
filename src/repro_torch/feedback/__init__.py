"""repro_torch.feedback — the serve → log → learn → redeploy loop
(counterpart of ``repro.feedback``).

  qlog    — bounded, thread-safe JSONL query-log writer capturing per-query
            route signals, the chosen rung, telemetry, latency, and a
            "needed wide beam" label from periodic shadow oversearch
            (``ShadowOversearch``)
  replay  — deterministic offline replay of a captured log: re-drive the
            routing decision (formula or learned) and score it against the
            shadow labels (counterfactual regret, routed-vs-oracle)
  fit     — a small PyTorch-trained logistic/MLP hardness predictor over
            the logged route signals, plus quantile calibration of
            ``hard_frac`` and the ladder ``VotePolicy`` thresholds from
            logged rolling windows; artifacts are versioned via
            ``repro_torch.ckpt``

Serving picks a new predictor up without restarting:
``HardnessRouter.load_predictor`` swaps it atomically (the predictor runs on
the host before the bucketed split, so ``search_jit_cache_size()`` stays
flat) and ``ServeDaemon`` exposes ``POST /reload`` on the metrics server.
"""
from repro_torch.feedback.fit import (
    HardnessPredictor,
    calibrate,
    fit_from_records,
    load_predictor,
    save_predictor,
)
from repro_torch.feedback.qlog import QueryLog, ShadowOversearch
from repro_torch.feedback.replay import read_log, replay_compare, replay_routing

__all__ = [
    "HardnessPredictor",
    "QueryLog",
    "ShadowOversearch",
    "calibrate",
    "fit_from_records",
    "load_predictor",
    "read_log",
    "replay_compare",
    "replay_routing",
    "save_predictor",
]
