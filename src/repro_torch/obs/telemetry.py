"""Per-query search telemetry, as ``repro.obs.telemetry`` defines it.

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

from typing import NamedTuple

import numpy as np
import torch


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


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def summarize(tele: SearchTelemetry) -> dict:
    """Host-side scalar summary (means) of a telemetry batch."""
    t = SearchTelemetry(*(_np(a) for a in tele))
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
