"""Deterministic query-log replay (counterpart of
``repro.feedback.replay``, copied: it is host-only NumPy): reconstruct the
batches a routed serving run saw and re-drive the *routing decision*
offline.

Replay needs no index, no device and no RNG, so it is exactly
reproducible: the same log replayed twice yields identical counterfactual
numbers.  That makes it the offline evaluation harness for routing
policies: score the formula router, a candidate predictor and the oracle on
the *same* captured traffic before anything touches serving.

Scoring uses the shadow-oversearch labels captured in the log
(``needed_wide`` per query).  For a routing decision on a labeled batch:

  miss   — query labeled "needed wide beam" but routed easy
           (a likely recall loss; weight 1)
  spare  — query labeled "easy" but routed hard
           (wasted beam; weight ``spare_cost`` < 1 — overrouting costs
           compute, underrouting costs recall)

``regret = (misses + spare_cost · spares) / labeled_queries`` — the oracle
(route hard exactly the labeled queries) has regret 0 by construction.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np


def read_log(path: str) -> List[Dict]:
    """Load a JSONL query log; blank/corrupt tail lines are skipped (a
    killed writer may leave a torn last line — the rest stays usable)."""
    out: List[Dict] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def batch_records(records: Iterable[Dict]) -> List[Dict]:
    """The routed-batch records (kind="batch" with routing info), in seq
    order — the replayable subset of a log."""
    rows = [r for r in records if r.get("kind") == "batch"
            and "route" in r and "signals" in r]
    return sorted(rows, key=lambda r: r.get("seq", 0))


def replay_routing(
    records: Iterable[Dict],
    *,
    scorer: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    hard_frac: float = 0.25,
    history: int = 1024,
    spare_cost: float = 0.25,
) -> Dict:
    """Re-drive the quantile split over a captured log, counterfactually.

    ``scorer`` maps the logged per-query feature matrix (B, F) to hardness
    scores — pass a fitted :class:`~repro_torch.feedback.fit.HardnessPredictor`
    to evaluate learned routing, or None to replay the logged formula
    hardness.  The split mechanics mirror ``HardnessRouter.split`` (rolling
    score history, threshold at the ``1 - hard_frac`` quantile) without any
    registry/window side effects.

    Returns aggregate counterfactual quality: ``regret`` (see module doc),
    miss/spare counts, agreement with the decision the live router actually
    took, and the per-batch hard counts (``hard_trace``).
    """
    if not 0.0 < hard_frac < 1.0:
        raise ValueError(f"hard_frac must be in (0, 1), got {hard_frac}")
    hist: deque = deque(maxlen=history)
    batches = labeled = misses = spares = 0
    queries = 0
    agree = compared = 0
    hard_trace: List[int] = []
    for rec in batch_records(records):
        sig = rec["signals"]
        if scorer is not None:
            feats = sig.get("features")
            if feats is None:
                continue
            h = np.asarray(scorer(np.asarray(feats, np.float64)),
                           np.float64).reshape(-1)
        else:
            h = np.asarray(sig["hardness"], np.float64).reshape(-1)
        hist.extend(h.tolist())
        thr = float(np.quantile(np.asarray(hist), 1.0 - hard_frac))
        hard_mask = h > thr
        batches += 1
        queries += h.size
        hard_trace.append(int(hard_mask.sum()))

        live_hard = np.zeros(h.size, bool)
        live_hard[np.asarray(rec["route"]["hard_idx"], int)] = True
        agree += int((hard_mask == live_hard).sum())
        compared += h.size

        labels = rec.get("needed_wide")
        if labels is not None:
            y = np.asarray(labels, bool)
            labeled += y.size
            misses += int((y & ~hard_mask).sum())
            spares += int((~y & hard_mask).sum())
    out: Dict = {
        "batches": batches,
        "queries": queries,
        "labeled": labeled,
        "misses": misses,
        "spares": spares,
        "spare_cost": spare_cost,
        "hard_frac": hard_frac,
        "mean_hard_frac": (float(np.sum(hard_trace)) / queries
                           if queries else 0.0),
        "agreement_with_live": (agree / compared) if compared else None,
        "hard_trace": hard_trace,
    }
    out["regret"] = ((misses + spare_cost * spares) / labeled
                     if labeled else None)
    return out


def replay_compare(
    records: Iterable[Dict],
    predictor,
    *,
    formula_hard_frac: float = 0.25,
    learned_hard_frac: Optional[float] = None,
    spare_cost: float = 0.25,
) -> Dict:
    """Formula vs learned vs oracle on the same log — the routed-vs-oracle
    regret table.  ``learned_hard_frac`` defaults to the predictor's
    calibrated fraction (falling back to the formula's)."""
    records = list(records)
    if learned_hard_frac is None:
        learned_hard_frac = (predictor.calibration or {}).get(
            "hard_frac", formula_hard_frac
        )
    formula = replay_routing(records, hard_frac=formula_hard_frac,
                             spare_cost=spare_cost)
    learned = replay_routing(records, scorer=predictor,
                             hard_frac=learned_hard_frac,
                             spare_cost=spare_cost)
    # the oracle routes hard exactly the labeled queries: regret 0 on the
    # labeled subset, reported for its hard fraction (the budget it implies)
    labeled = needed = 0
    for rec in batch_records(records):
        labels = rec.get("needed_wide")
        if labels is not None:
            y = np.asarray(labels, bool)
            labeled += y.size
            needed += int(y.sum())
    return {
        "formula": formula,
        "learned": learned,
        "oracle": {
            "labeled": labeled,
            "hard_frac": (needed / labeled) if labeled else None,
            "regret": 0.0 if labeled else None,
        },
    }
