"""The device trace of a run's window, read from the profiler's raw events.

``torch.profiler`` records only device activity (kernels, copies, fills).
The events are read from the raw kineto results, not through
``key_averages``, which builds a Python object an event.  Busy time is the
union of the device intervals; idle gaps are the rest of the window, each
labelled by what the harness was doing on the host at the time (its own
spans: a batch searched).
"""
from __future__ import annotations

import re
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

MARKER_NS = 20_000   # the spin kernel that marks the window's start


@dataclass
class Trace:
    """Device events of a window, on the host's ``perf_counter_ns`` clock."""

    events: List[Tuple[str, int, int]]   # (name, start, end)
    t0: int                              # window start (host ns)
    t1: int                              # window end (host ns)
    busy_ns: int = field(init=False)

    def __post_init__(self):
        self.events.sort(key=lambda e: e[1])
        busy, end = 0, self.t0
        for _, s, e in self.events:
            s, e = max(s, end), min(e, self.t1)
            if e > s:
                busy += e - s
                end = e
        self.busy_ns = busy

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return self.busy_ns * 1e-9

    def kernel_s(self, names) -> float:
        """Seconds of the events whose name holds any of ``names``."""
        return sum(e - s for n, s, e in self.events
                   if any(k in n for k in names)) * 1e-9

    def top_ops(self, n: int = 10) -> list:
        """``[[name, seconds], ...]``: the ``n`` operations that took the
        most device time, summed by name."""
        ns = Counter()
        for name, s, e in self.events:
            ns[short_name(name)] += e - s
        return [[k, v * 1e-9] for k, v in ns.most_common(n)]

    def idle_gaps(self, spans, n: int = 10) -> list:
        """``[[label, seconds], ...]``: the window's idle time, summed by
        the harness span open at each gap's middle (``spans``: sorted
        ``(start, end, label)`` host ns; outside any, ``between``) and by
        the gap's length, the largest ``n`` sums."""
        sums, counts = Counter(), Counter()
        prev = self.t0
        j = 0
        for _, s, e in self.events + [("", self.t1, self.t1)]:
            if s > prev:
                mid = (prev + s) // 2
                while j < len(spans) and spans[j][1] < mid:
                    j += 1
                label = (spans[j][2] if j < len(spans) and spans[j][0] <= mid
                         else "between")
                size = ("gaps under 1 ms" if s - prev < 1_000_000
                        else "gaps of 1 ms or more")
                sums[(label, size)] += s - prev
                counts[(label, size)] += 1
            prev = max(prev, e)
        return [[f"{label}: {counts[(label, size)]} {size}", v * 1e-9]
                for (label, size), v in sums.most_common(n)]


def short_name(name: str) -> str:
    """A kernel's name without its return type, arguments and namespaces,
    at most 80 characters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:   # drop the argument list, keep template arguments
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()[:80]


class Recorder:
    """``with Recorder(torch) as rec:`` profiles the device over the block;
    ``rec.trace`` is the ``Trace`` after it.  The window starts at a spin
    kernel launched on an idle card, which aligns the device clock to the
    host's."""

    def __init__(self, torch):
        self.torch = torch
        self.trace: Optional[Trace] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.torch.cuda.synchronize()
        self._h0 = time.perf_counter_ns()
        self.torch.cuda._sleep(MARKER_NS)
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        h1 = time.perf_counter_ns()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        from torch.autograd import DeviceType

        raw = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
        marks = [ev for ev in raw if "spin" in ev[0]] or sorted(
            raw, key=lambda ev: ev[1])[:1]
        if not marks:
            raise RuntimeError("the profiler recorded no device activity")
        shift = min(m[1] for m in marks) - self._h0
        self.trace = Trace([(n, s - shift, e - shift) for n, s, e in raw],
                           self._h0, h1)
        return False
