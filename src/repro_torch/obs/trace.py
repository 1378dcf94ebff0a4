"""Host-side spans → chrome://tracing-compatible JSONL.

The port's own copy of ``repro.obs.trace``.

``span(name)`` / ``@traced`` wrap the host phases (index build stages,
prefill/decode, RAG retrieve, train steps).  Events are Trace Event Format
"complete" events (``ph: "X"``) written one JSON object per line; the file
opens with ``[`` so chrome://tracing / Perfetto load it directly (the trailing
``]`` is optional in the format, which is what makes line-appending safe for
crashing processes).

Disabled (the default) the span body costs one attribute load and a branch —
no clock reads, no allocation of event dicts.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class Tracer:
    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._file = None
        self._path: Optional[str] = None
        self._t0 = time.perf_counter()

    # -------------------------------------------------------------- control
    def start(self, path: Optional[str] = None) -> None:
        """Enable tracing; if ``path`` is given, stream events to it."""
        with self._lock:
            self._events.clear()
            self._t0 = time.perf_counter()
            if self._file is not None:
                self._file.close()
                self._file = None
            self._path = path
            if path:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                self._file = open(path, "w")
                self._file.write("[\n")
            self.enabled = True

    def stop(self) -> None:
        with self._lock:
            self.enabled = False
            if self._file is not None:
                self._file.close()
                self._file = None

    @property
    def path(self) -> Optional[str]:
        return self._path

    # -------------------------------------------------------------- record
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def emit(self, event: dict) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._events.append(event)
            if self._file is not None:
                self._file.write(json.dumps(event) + ",\n")
                self._file.flush()

    def complete_event(
        self, name: str, ts_us: float, dur_us: float,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.emit({
            "name": name, "ph": "X", "ts": ts_us, "dur": dur_us,
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": args or {},
        })

    def instant(self, name: str, args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        self.emit({
            "name": name, "ph": "i", "ts": self._now_us(), "s": "t",
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": args or {},
        })

    # -------------------------------------------------------------- export
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def dump(self, path: str) -> str:
        """Write the in-memory buffer as a chrome trace file."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write("[\n")
            for e in self.events():
                f.write(json.dumps(e) + ",\n")
        return path

    def span_summary(self) -> Dict[str, dict]:
        """name -> {count, total_s, mean_s} over complete events."""
        out: Dict[str, dict] = {}
        for e in self.events():
            if e.get("ph") != "X":
                continue
            s = out.setdefault(e["name"], {"count": 0, "total_s": 0.0})
            s["count"] += 1
            s["total_s"] += e["dur"] / 1e6
        for s in out.values():
            s["mean_s"] = s["total_s"] / s["count"]
        return out


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


@contextmanager
def span(name: str, **attrs):
    """Time a host-side phase; no-op (one branch) when tracing is disabled.

    Attribute values land in the trace event's ``args`` and must be
    JSON-serializable.
    """
    t = _TRACER
    if not t.enabled:
        yield
        return
    ts = t._now_us()
    try:
        yield
    finally:
        t.complete_event(name, ts, t._now_us() - ts, attrs or None)


def traced(name: Optional[str] = None):
    """Decorator form of ``span``; defaults to the function's qualname."""

    def deco(fn):
        sname = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with span(sname):
                return fn(*a, **kw)

        return wrapped

    return deco


def read_trace(path: str) -> List[dict]:
    """Parse a trace file written by this module (or any chrome JSON array)."""
    with open(path) as f:
        text = f.read().strip()
    if text.startswith("["):
        text = text[1:]
    text = text.rstrip().rstrip("]").rstrip().rstrip(",")
    if not text:
        return []
    return json.loads("[" + text + "]")
