"""Rolling-window aggregation of per-batch search telemetry.

The port's own copy of ``repro.obs.window``.

The serving daemon pushes one ``summarize(tele)`` dict (plus the measured
batch latency) per request batch; ``RollingWindow`` keeps the last N of them
in a fixed-size ring and exposes a thread-safe ``snapshot()`` the exporter
(``/debug/telemetry``) and the ``AdaptiveController`` both read.

Aggregation is over *per-batch statistics*, not raw per-query values — the
whole point of the window is that it stays O(N) regardless of traffic, so
window quantiles are quantiles across batches (latency percentiles across
per-batch latencies; ``entry_rank_proxy_p95`` is the p95 across per-batch
p95s).  That is a bucket-free approximation, adequate for SLO display and
control decisions; exact per-query distributions live in the registry
histograms, which never forget.
"""
from __future__ import annotations

import json
import math
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional

import numpy as np

# snapshot keys that are query-weighted means of the per-batch means
_MEAN_KEYS = (
    "mean_hops",
    "mean_dist_evals",
    "mean_converged_hop",
    "mean_nav_hops",
    "mean_entry_rank_proxy",
)


class RollingWindow:
    """Fixed-size ring of per-batch summary dicts.

    ``push`` accepts any dict; the canonical producer is
    ``obs.summarize(tele)`` augmented with ``latency_s`` (batch wall time)
    and optionally ``recall`` (when ground truth is known, e.g. benchmarks).
    Missing keys are simply absent from the aggregate — the window never
    raises on partial summaries.
    """

    def __init__(self, size: int = 32):
        if size < 1:
            raise ValueError(f"window size must be >= 1, got {size}")
        self.size = size
        self._ring: deque = deque(maxlen=size)
        self._lock = threading.Lock()
        self._pushed = 0  # total batches ever pushed (not just retained)

    def push(self, summary: Dict) -> None:
        with self._lock:
            self._ring.append(dict(summary))
            self._pushed += 1

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total_pushed(self) -> int:
        return self._pushed

    # ----------------------------------------------------------- persistence
    def to_dict(self) -> Dict:
        """Stable JSON-able form: retained rows + ring geometry.  The
        round-trip contract (``from_dict(to_dict()).snapshot() ==
        snapshot()``) is what the feedback loop's calibration relies on —
        query logs carry windows in this form."""
        with self._lock:
            return {
                "size": self.size,
                "total_pushed": self._pushed,
                "rows": [dict(r) for r in self._ring],
            }

    @classmethod
    def from_dict(cls, d: Dict) -> "RollingWindow":
        w = cls(int(d["size"]))
        for row in d.get("rows", []):
            w._ring.append(dict(row))
        w._pushed = int(d.get("total_pushed", len(w._ring)))
        return w

    def to_json(self, **dumps_kw) -> str:
        return json.dumps(self.to_dict(), **dumps_kw)

    @classmethod
    def from_json(cls, s: str) -> "RollingWindow":
        return cls.from_dict(json.loads(s))

    # ------------------------------------------------------------- aggregate
    def _rows(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def snapshot(self) -> Dict:
        """Aggregate over the retained batches.

        Keys (all optional except ``batches``/``queries``):
          latency_p50/p95/p99   quantiles of per-batch ``latency_s``
          qps                   queries / summed latency
          mean_*                query-weighted means of per-batch means
          entry_rank_proxy_p50  median of per-batch mean proxies
          entry_rank_proxy_p95  p95 of per-batch ``p95_entry_rank_proxy``
          eviction_rate         ring evictions per query over the window
          ring_overflow_rate    fraction of queries whose ring overflowed
        """
        rows = self._rows()
        out: Dict = {"batches": len(rows), "window": self.size,
                     "total_pushed": self._pushed}
        if not rows:
            out["queries"] = 0
            return out

        weights = np.asarray([r.get("queries", 1) for r in rows], np.float64)
        queries = float(weights.sum())
        out["queries"] = int(queries)

        lat = _column(rows, "latency_s")
        if lat.size:
            out["latency_p50"] = float(np.quantile(lat, 0.5))
            out["latency_p95"] = float(np.quantile(lat, 0.95))
            out["latency_p99"] = float(np.quantile(lat, 0.99))
            total_s = float(lat.sum())
            if total_s > 0:
                out["qps"] = queries / total_s

        for key in _MEAN_KEYS:
            vals, w = _column(rows, key, weights)
            if vals.size:
                out[key] = float(np.average(vals, weights=w))

        proxies, _ = _column(rows, "mean_entry_rank_proxy", weights)
        if proxies.size:
            out["entry_rank_proxy_p50"] = float(np.quantile(proxies, 0.5))
        p95s = _column(rows, "p95_entry_rank_proxy")
        if p95s.size:
            out["entry_rank_proxy_p95"] = float(np.quantile(p95s, 0.95))

        ev = _column(rows, "ring_evictions_total")
        if ev.size and queries > 0:
            out["eviction_rate"] = float(ev.sum()) / queries
        ov = _column(rows, "ring_overflow_queries")
        if ov.size and queries > 0:
            out["ring_overflow_rate"] = float(ov.sum()) / queries

        rec, w = _column(rows, "recall", weights)
        if rec.size:
            out["recall"] = float(np.average(rec, weights=w))
        return out


def _column(rows: Iterable[Dict], key: str, weights: Optional[np.ndarray] = None):
    """Values of ``key`` across rows (NaNs and absences dropped); with
    ``weights`` also returns the matching weight subset."""
    vals, w = [], []
    for i, r in enumerate(rows):
        v = r.get(key)
        if v is None or (isinstance(v, float) and math.isnan(v)):
            continue
        vals.append(float(v))
        if weights is not None:
            w.append(weights[i])
    arr = np.asarray(vals, np.float64)
    if weights is None:
        return arr
    return arr, np.asarray(w, np.float64) if w else np.ones_like(arr)
