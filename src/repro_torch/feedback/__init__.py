"""Feedback loop (counterpart of ``repro.feedback``): query-log capture and
shadow-oversearch labels.  Replay and the hardness-predictor fit are not
ported yet (ROADMAP A6)."""
from repro_torch.feedback.qlog import QueryLog, ShadowOversearch

__all__ = ["QueryLog", "ShadowOversearch"]
