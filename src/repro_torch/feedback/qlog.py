"""Query-log capture: a bounded, thread-safe JSONL writer that
records what routed serving actually did — per-query route signals, the
chosen rung, telemetry, latency — plus a ground-truth-ish "needed wide
beam" label obtained by periodic shadow oversearch.

Design constraints, in order:

  * **Never hurt serving.**  Records are buffered host-side dicts; the file
    write happens at most every ``flush_every`` records, and the newest
    record is always kept in the buffer so the serving loop can
    ``annotate_last`` (latency, shadow labels) after the search returns
    without re-opening anything.
  * **Bounded.**  ``max_records`` / ``max_bytes`` cap the file; beyond the
    cap new records are dropped and counted (``feedback.qlog_dropped``) —
    a query log is a sliding sample of traffic, not an audit trail.
  * **Crash-tolerant tail.**  ``close()`` flushes and fsyncs, and
    ``ServeDaemon.stop()`` calls it on SIGTERM/stop, so short runs never
    lose the tail records.

The writer doubles as a *telemetry sink* (``qlog.sink``) so it plugs into
the existing ``telemetry_sink=`` seam of ``GateIndex.search_routed`` /
``GateIndex.search`` — sinks that declare ``report=``/``queries=`` (or
``**extra``) receive the routing report alongside the telemetry.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.registry import MetricsRegistry, get_registry
from repro_torch.obs.telemetry import summarize, to_numpy

# per-query telemetry leaves worth replaying offline (ints kept small)
_TELE_FIELDS = ("hops", "dist_evals", "converged_hop", "entry_rank_proxy")


def _jsonable(x):
    """numpy → plain python, recursively (records must round-trip json)."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return _jsonable(x.tolist())
    if isinstance(x, (np.bool_,)):
        return bool(x)
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    return x


class QueryLog:
    """Bounded, thread-safe JSONL query-log writer (+ in-memory ring).

    ``path=None`` keeps records only in the in-memory ring (``records()``)
    — what benchmarks and tests use; with a path, records are also appended
    as JSON lines.  One record per *batch* with per-query arrays: compact,
    and replay naturally reconstructs the batches the router actually saw.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        max_records: int = 100_000,
        max_bytes: int = 64 * 1024 * 1024,
        flush_every: int = 16,
        memory_records: int = 4096,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.path = path
        self.max_records = max_records
        self.max_bytes = max_bytes
        self.flush_every = max(1, flush_every)
        self._buf: List[Dict] = []
        self._ring: deque = deque(maxlen=memory_records)
        self._lock = threading.Lock()
        self._file = open(path, "a", encoding="utf-8") if path else None
        self._seq = 0
        self.written = 0          # records serialized to disk
        self.bytes_written = 0
        self.dropped = 0
        self._reg = registry if registry is not None else get_registry()
        self._closed = False

    # ------------------------------------------------------------------ write
    def log(self, record: Dict) -> bool:
        """Append one record; returns False when the bound dropped it."""
        with self._lock:
            if self._closed or self._seq >= self.max_records or (
                self.max_bytes and self.bytes_written >= self.max_bytes
            ):
                self.dropped += 1
                if self._reg.enabled:
                    self._reg.counter(
                        "feedback.qlog_dropped",
                        "query-log records dropped by the size bound",
                    ).inc()
                return False
            record = dict(record)
            record.setdefault("seq", self._seq)
            self._seq += 1
            self._buf.append(record)
            self._ring.append(record)
            if self._reg.enabled:
                self._reg.counter(
                    "feedback.qlog_records", "query-log records captured"
                ).inc()
            # flush all but the newest record: the serving loop may still
            # annotate_last() it (latency, shadow labels) before the next log
            if len(self._buf) > self.flush_every:
                self._flush_locked(keep_last=True)
            return True

    def annotate_last(self, **fields) -> None:
        """Merge fields into the most recent record (still buffered by
        construction — see ``log``); no-op when nothing was logged yet."""
        with self._lock:
            if self._buf:
                self._buf[-1].update(_jsonable(fields))
            elif self._ring:      # memory-only ring after an explicit flush
                self._ring[-1].update(_jsonable(fields))

    def _flush_locked(self, keep_last: bool = False) -> None:
        cut = len(self._buf) - 1 if keep_last and self._buf else len(self._buf)
        if cut <= 0:
            return
        out, self._buf = self._buf[:cut], self._buf[cut:]
        if self._file is not None:
            for r in out:
                line = json.dumps(_jsonable(r), separators=(",", ":"))
                self._file.write(line + "\n")
                self.bytes_written += len(line) + 1
                self.written += 1
        else:
            self.written += len(out)

    def flush(self, fsync: bool = False) -> None:
        with self._lock:
            self._flush_locked()
            if self._file is not None:
                self._file.flush()
                if fsync:
                    os.fsync(self._file.fileno())

    def close(self) -> None:
        """Flush + fsync + close — the tail of a short run must hit disk
        (wired into ``ServeDaemon.stop()`` / SIGTERM)."""
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())
                self._file.close()
                self._file = None
            self._closed = True

    def __enter__(self) -> "QueryLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------- read
    def records(self) -> List[Dict]:
        """The in-memory ring (most recent ``memory_records`` records)."""
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return self._seq

    # ------------------------------------------------------------------- sink
    def sink(self, tele, *, params=None, where: str = "search",
             report=None, queries=None, **_extra) -> None:
        """Telemetry-sink adapter: ``search_routed(telemetry_sink=qlog.sink)``
        logs one batch record per call.  ``report`` (a ``RouteReport``) adds
        the routing decision + raw signals; chain with ``registry_sink`` via
        :func:`repro_torch.obs.telemetry.chain_sinks` to keep metrics too."""
        host = to_numpy(tele)
        t = {f: getattr(host, f) for f in _TELE_FIELDS}
        rec: Dict = {
            "kind": "batch",
            "where": where,
            "batch": int(t["hops"].shape[0]),
            "summary": summarize(host),
            "telemetry": {k: v.tolist() for k, v in t.items()},
        }
        if params is not None:
            rec["params"] = dataclasses.asdict(params)
        if report is not None:
            rec["route"] = {
                "threshold": report.threshold,
                "hard_frac": getattr(report, "hard_frac", None),
                "easy_rung": [report.easy_rung.beam_width,
                              report.easy_rung.max_hops],
                "hard_rung": [report.hard_rung.beam_width,
                              report.hard_rung.max_hops],
                "easy_idx": report.easy_idx.tolist(),
                "hard_idx": report.hard_idx.tolist(),
                "predictor_version": getattr(
                    report, "predictor_version", None
                ),
            }
            signals: Dict = {}
            for name in ("hardness", "features", "scores"):
                v = getattr(report, name, None)
                if v is not None:
                    signals[name] = np.asarray(v).tolist()
            if signals:
                rec["signals"] = signals
        self.log(rec)

    def log_window(self, window, *, name: str = "serve",
                   extra: Optional[Dict] = None) -> None:
        """Periodic rolling-window record (``RollingWindow.to_json`` form) —
        what ``fit.calibrate`` reads the vote-threshold quantiles from."""
        rec = {"kind": "window", "name": name, "window": window.to_dict()}
        if extra:
            rec.update(_jsonable(extra))
        self.log(rec)


class ShadowOversearch:
    """Periodic "needed wide beam" labeling.

    Every ``every``-th call, re-run the *whole* batch at the router's easy
    and hard rungs and compare per query: a query needed the wide beam iff
    the easy rung's top-k misses ids the hard rung found.  It costs the two
    extra searches, amortized by ``every``.
    """

    def __init__(self, index, router, *, every: int = 4,
                 registry: Optional[MetricsRegistry] = None, device="cuda"):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.index = index
        self.router = router
        self.every = every
        self.device = device
        self._calls = 0
        self._reg = registry if registry is not None else get_registry()

    def maybe_label(self, queries, base) -> Optional[np.ndarray]:
        """Labels for this batch, or None on off-cycle / off-size batches."""
        self._calls += 1
        if (self._calls - 1) % self.every != 0:
            return None
        if len(queries) != self.router.batch_size:
            return None           # only labels full serving batches
        return self.label(queries, base)

    def label(self, queries, base) -> np.ndarray:
        """(B,) bool — easy rung's top-k differs from the hard rung's."""
        idx = self.index
        easy, _ = idx.search(
            queries, params=self.router.rung_params(self.router.easy_rung,
                                                    base),
            telemetry_sink=None, device=self.device,
        )
        hard, _ = idx.search(
            queries, params=self.router.rung_params(self.router.hard_rung,
                                                    base),
            telemetry_sink=None, device=self.device,
        )
        e = easy.ids.cpu().numpy()
        h = hard.ids.cpu().numpy()
        k = min(base.k, h.shape[1])
        needed = np.empty((e.shape[0],), bool)
        for i in range(e.shape[0]):
            truth = set(int(x) for x in h[i, :k] if x >= 0)
            got = set(int(x) for x in e[i] if x >= 0)
            needed[i] = bool(truth - got)
        if self._reg.enabled:
            self._reg.counter(
                "feedback.shadow_batches", "batches shadow-oversearched"
            ).inc()
            self._reg.counter(
                "feedback.shadow_needed_wide",
                "shadow-labeled queries that needed the wide beam",
            ).inc(int(needed.sum()))
        return needed
