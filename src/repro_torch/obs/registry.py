"""Unified metrics registry: counters, gauges, histograms.

The port's own copy of ``repro.obs.registry`` (same names, buckets and
export formats).  Design constraints:
  * thread-safe — search, serving and benchmarks record from host threads
  * near-zero overhead when disabled — every record path is one attribute
    load + one branch before touching any lock
  * fixed histogram bucket edges — merging across processes/exports stays
    trivial and the Prometheus text exposition is exact
  * two export formats — JSON (benchmarks, tests) and Prometheus text
    (scrape endpoint for the production serving seat)

The module-level default registry (``get_registry()``) is what the search /
serve / train instrumentation writes to; tests construct private registries.
"""
from __future__ import annotations

import json
import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Edges chosen for search telemetry: hop counts and distance evaluations are
# small integers / few-thousands; powers-of-two keep the histogram meaningful
# from toy CPU surrogates up to billion-scale runs.
POW2_BUCKETS: Tuple[float, ...] = tuple(float(2 ** i) for i in range(17))
# Latency seconds: 100us .. ~100s, roughly 1-2-5 per decade.
LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2e-4, 5e-4, 1e-3, 2e-3, 5e-3, 1e-2, 2e-2, 5e-2,
    0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 120.0,
)


class Counter:
    """Monotonically increasing float counter."""

    __slots__ = ("name", "help", "_value", "_lock", "_reg")

    def __init__(self, name: str, help: str, reg: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()
        self._reg = reg

    def inc(self, v: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        if v < 0:
            raise ValueError(f"counter {self.name}: negative increment {v}")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "help", "_value", "_lock", "_reg")

    def __init__(self, name: str, help: str, reg: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()
        self._reg = reg

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bucket histogram (cumulative-on-export, per-bucket in memory).

    ``observe_many`` takes any array-like and bins it with one
    ``np.searchsorted`` — the path used for per-query device telemetry, where
    a whole batch of hop counts lands at once.
    """

    __slots__ = ("name", "help", "edges", "_counts", "_sum", "_lock", "_reg")

    def __init__(
        self,
        name: str,
        help: str,
        reg: "MetricsRegistry",
        buckets: Sequence[float] = POW2_BUCKETS,
    ):
        edges = tuple(float(b) for b in buckets)
        if list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram {name}: bucket edges must be "
                             f"strictly increasing, got {edges}")
        self.name = name
        self.help = help
        self.edges = edges
        self._counts = np.zeros(len(edges) + 1, np.int64)  # last = +Inf
        self._sum = 0.0
        self._lock = threading.Lock()
        self._reg = reg

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        i = int(np.searchsorted(self.edges, v, side="left"))
        with self._lock:
            self._counts[i] += 1
            self._sum += float(v)

    def observe_many(self, values) -> None:
        if not self._reg.enabled:
            return
        arr = np.asarray(values, np.float64).reshape(-1)
        if arr.size == 0:
            return
        idx = np.searchsorted(self.edges, arr, side="left")
        binned = np.bincount(idx, minlength=len(self.edges) + 1)
        with self._lock:
            self._counts += binned
            self._sum += float(arr.sum())

    @property
    def count(self) -> int:
        return int(self._counts.sum())

    @property
    def sum(self) -> float:
        return self._sum

    def mean(self) -> float:
        n = self.count
        return self._sum / n if n else math.nan

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper edge of the containing bucket)."""
        n = self.count
        if n == 0:
            return math.nan
        target = q * n
        cum = np.cumsum(self._counts)
        i = int(np.searchsorted(cum, target, side="left"))
        return self.edges[i] if i < len(self.edges) else math.inf

    def snapshot(self) -> dict:
        return {
            "type": "histogram",
            "buckets": list(self.edges),
            "counts": self._counts.tolist(),
            "count": self.count,
            "sum": self._sum,
            "mean": self.mean(),
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Named instruments behind one lock; idempotent registration."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    # -------------------------------------------------------- registration
    def _get_or_make(self, name: str, kind, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = kind(name, reg=self, **kw)
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {kind.__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(name, Gauge, help=help)

    def histogram(
        self, name: str, help: str = "", buckets: Sequence[float] = POW2_BUCKETS
    ) -> Histogram:
        return self._get_or_make(name, Histogram, help=help, buckets=buckets)

    # -------------------------------------------------------------- control
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop all instruments (benchmarks reset between runs)."""
        with self._lock:
            self._metrics.clear()

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str):
        return self._metrics.get(name)

    # -------------------------------------------------------------- export
    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(items)}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in items:
            pname = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
            if re.match(r"^[0-9]", pname):
                pname = "_" + pname
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_fmt(m.value)}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for edge, c in zip(m.edges, m._counts[:-1]):
                    cum += int(c)
                    lines.append(f'{pname}_bucket{{le="{_fmt(edge)}"}} {cum}')
                cum += int(m._counts[-1])
                lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{pname}_sum {_fmt(m.sum)}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_REGISTRY = MetricsRegistry(enabled=True)


def get_registry() -> MetricsRegistry:
    """Process-wide default registry."""
    return _REGISTRY
