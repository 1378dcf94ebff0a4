"""Search, serve and build observability (counterpart of ``repro.obs``).

  registry   counters / gauges / fixed-bucket histograms; JSON and
             Prometheus-text export (``get_registry()``)
  trace      host-side ``span()`` / ``@traced`` → chrome://tracing JSONL
  telemetry  ``SearchTelemetry`` from the search loop, registry recording,
             the ring-overflow warning and the telemetry-sink helpers
  exporter   ``MetricsExporter``: /metrics, /metrics.json, /healthz,
             /debug/telemetry, POST /reload over stdlib http.server
  window     ``RollingWindow``: last-N-batches SLO aggregates
  adaptive   ``AdaptiveController``: telemetry-driven beam / max_hops ladder
  router     ``HardnessRouter``: splits each batch by predicted hardness and
             runs each side at its own ladder rung
             (``GateIndex.search_routed``)
"""
from repro_torch.obs.adaptive import (
    AdaptiveController,
    DEFAULT_LADDER,
    LadderRung,
    VotePolicy,
)
from repro_torch.obs.exporter import MetricsExporter
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    LATENCY_BUCKETS,
    MetricsRegistry,
    POW2_BUCKETS,
    get_registry,
)
from repro_torch.obs.router import HardnessRouter, RouteReport, route_buckets
from repro_torch.obs.telemetry import (
    RATIO_BUCKETS,
    SearchTelemetry,
    call_telemetry_sink,
    chain_sinks,
    record_search_telemetry,
    registry_sink,
    summarize,
    warn_on_ring_overflow,
)
from repro_torch.obs.trace import Tracer, get_tracer, read_trace, span, traced
from repro_torch.obs.window import RollingWindow

__all__ = [
    "AdaptiveController",
    "Counter",
    "DEFAULT_LADDER",
    "Gauge",
    "HardnessRouter",
    "Histogram",
    "LATENCY_BUCKETS",
    "LadderRung",
    "MetricsExporter",
    "MetricsRegistry",
    "POW2_BUCKETS",
    "RATIO_BUCKETS",
    "RollingWindow",
    "RouteReport",
    "SearchTelemetry",
    "Tracer",
    "VotePolicy",
    "call_telemetry_sink",
    "chain_sinks",
    "get_registry",
    "get_tracer",
    "read_trace",
    "record_search_telemetry",
    "registry_sink",
    "route_buckets",
    "span",
    "summarize",
    "traced",
    "warn_on_ring_overflow",
]
