"""Per-query search telemetry, as ``repro.obs.telemetry`` defines it, and
its host-side consumers: registry recording, the ring-overflow warning,
summaries and the telemetry-sink helpers.

Field ↔ meaning:
  hops              search path length ℓ (Algorithm-1 expansion count)
  dist_evals        distance computations (the paper's cost unit)
  ring_evictions    visited-ring slots overwritten while still holding a
                    live id (each re-opens a node for re-scoring)
  converged_hop     first hop after which the top-k beam prefix never
                    changed again
  nav_hops          navigation-graph greedy-descent length (GATE entry)
  entry_dist        best entry candidate's distance to the query
  entry_rank_proxy  entry_dist / final top-1 distance
  bytes_read        estimated device-memory bytes this query's search read
                    (traffic model of ``graphs.search``); float32, because
                    an int32 count wraps for wide vectors
"""
from __future__ import annotations

import inspect
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.obs.registry import MetricsRegistry, POW2_BUCKETS, get_registry


class SearchTelemetry(NamedTuple):
    """Per-query counters; every field is a (B,) tensor."""

    hops: torch.Tensor             # int32
    dist_evals: torch.Tensor       # int32
    ring_evictions: torch.Tensor   # int32
    converged_hop: torch.Tensor    # int32
    nav_hops: torch.Tensor         # int32
    entry_dist: torch.Tensor       # float32
    entry_rank_proxy: torch.Tensor # float32
    bytes_read: torch.Tensor       # float32


# Ratio buckets for entry_rank_proxy: 1.0 = perfect entry.
RATIO_BUCKETS = (1.0, 1.5, 2.0, 3.0, 5.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                 256.0, 1024.0)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def to_numpy(tele: SearchTelemetry) -> SearchTelemetry:
    """The same telemetry with every field a host numpy array."""
    return SearchTelemetry(*(_np(a) for a in tele))


def summarize(tele: SearchTelemetry) -> dict:
    """Host-side scalar summary (means) of a telemetry batch."""
    t = to_numpy(tele)
    overflow = int((t.ring_evictions > 0).sum())
    return {
        "queries": int(t.hops.shape[0]),
        "mean_hops": float(t.hops.mean()),
        "mean_dist_evals": float(t.dist_evals.mean()),
        "mean_converged_hop": float(t.converged_hop.mean()),
        "mean_nav_hops": float(t.nav_hops.mean()),
        "mean_entry_dist": float(t.entry_dist.mean()),
        "mean_entry_rank_proxy": float(t.entry_rank_proxy.mean()),
        "p95_entry_rank_proxy": float(
            np.quantile(np.atleast_1d(t.entry_rank_proxy), 0.95)
        ),
        "ring_evictions_total": int(t.ring_evictions.sum()),
        "ring_overflow_queries": overflow,
        "mean_bytes_read": float(t.bytes_read.mean()),
    }


def record_search_telemetry(
    tele: SearchTelemetry,
    registry: MetricsRegistry = None,
    prefix: str = "search",
) -> None:
    """Fold a telemetry batch into registry histograms/counters."""
    reg = registry if registry is not None else get_registry()
    if not reg.enabled:
        return
    t = to_numpy(tele)
    reg.counter(f"{prefix}.queries", "queries searched").inc(t.hops.shape[0])
    reg.histogram(
        f"{prefix}.hops", "search path length (hops)", POW2_BUCKETS
    ).observe_many(t.hops)
    reg.histogram(
        f"{prefix}.dist_evals", "distance evaluations per query", POW2_BUCKETS
    ).observe_many(t.dist_evals)
    reg.histogram(
        f"{prefix}.converged_hop", "hop at which top-k prefix stabilized",
        POW2_BUCKETS,
    ).observe_many(t.converged_hop)
    reg.histogram(
        f"{prefix}.nav_hops", "nav-graph descent length", POW2_BUCKETS
    ).observe_many(t.nav_hops)
    reg.histogram(
        f"{prefix}.entry_rank_proxy",
        "entry distance / final top-1 distance", RATIO_BUCKETS,
    ).observe_many(t.entry_rank_proxy)
    reg.counter(
        f"{prefix}.ring_evictions", "visited-ring live-slot evictions"
    ).inc(int(t.ring_evictions.sum()))
    reg.counter(
        f"{prefix}.bytes_read",
        "estimated HBM bytes read by search (kernel traffic model)",
    ).inc(float(t.bytes_read.astype(np.float64).sum()))


def registry_sink(
    tele: SearchTelemetry,
    *,
    params=None,
    where: str = "search",
    prefix: str = "search",
    registry: MetricsRegistry = None,
    **_extra,
) -> None:
    """The default ``telemetry_sink``: fold the batch into the metrics
    registry and warn on visited-ring overflow.

    A *telemetry sink* is any callable ``sink(tele, *, params, where)``;
    ``GateIndex.search(..., telemetry_sink=None)`` skips the side effects
    (the telemetry is still returned).  Sinks that also declare
    ``report=`` / ``queries=`` (or ``**extra``) receive routed search's
    richer context, see :func:`call_telemetry_sink`; this one ignores it.
    """
    record_search_telemetry(tele, registry, prefix)
    ring = getattr(params, "visited_ring", 0) if params is not None else 0
    warn_on_ring_overflow(tele, ring, where=where, registry=registry)


def call_telemetry_sink(sink, tele, *, params=None, where: str = "search",
                        **extra) -> None:
    """Invoke a telemetry sink, forwarding only the ``extra`` keywords it
    accepts (all of them to a sink with ``**kwargs``); if its signature
    cannot be read, the call falls back to the base form."""
    if sink is None:
        return
    if extra:
        try:
            sig = inspect.signature(sink)
            params_ = sig.parameters
            if not any(p.kind is inspect.Parameter.VAR_KEYWORD
                       for p in params_.values()):
                extra = {k: v for k, v in extra.items() if k in params_}
        except (TypeError, ValueError):
            extra = {}
    sink(tele, params=params, where=where, **extra)


def chain_sinks(*sinks) -> Callable:
    """Compose telemetry sinks: each non-None sink runs in order with the
    same payload (extras filtered per sink via :func:`call_telemetry_sink`),
    so serving keeps ``registry_sink`` metrics and query-log capture on the
    one ``telemetry_sink=`` seam."""
    kept = tuple(s for s in sinks if s is not None)

    def chained(tele, *, params=None, where="search", **extra):
        for s in kept:
            call_telemetry_sink(s, tele, params=params, where=where, **extra)

    return chained


def warn_on_ring_overflow(
    tele: SearchTelemetry,
    visited_ring: int,
    where: str = "search",
    registry: MetricsRegistry = None,
) -> int:
    """Warn when a query's expansions outgrew its visited ring (evicted
    nodes can be re-scored) and count the affected queries on
    ``search.ring_overflow_queries``.  Returns that count."""
    ev = _np(tele.ring_evictions)
    n = int((ev > 0).sum())
    if n:
        reg = registry if registry is not None else get_registry()
        reg.counter(
            "search.ring_overflow_queries",
            "queries whose visited ring overflowed (possible re-scoring)",
        ).inc(n)
        warnings.warn(
            f"[{where}] visited-ring overflow on {n}/{ev.shape[0]} queries "
            f"({int(ev.sum())} evictions, ring={visited_ring}): nodes may be "
            f"re-scored; raise visited_ring or lower max_hops/beam_width",
            RuntimeWarning,
            stacklevel=3,
        )
    return n
