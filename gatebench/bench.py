"""One run of one cell: set-up, the measured window, the reference's check,
and the result's line.

Set-up (``setup_s``, from the harness's first line to the window's start):
the kernels from the checkout's cache (built by the first run there), the
configuration's dataset and queries, the index build, and one search at
the cell's own parameters.  The window drives the mix for ``--seconds``;
with ``--trace 1`` the profiler records the device over it.  After it:
the peak memory, the answers to the host, the hop kernels' bounds (a
replay, traced runs only), the program's state freed, then the
reference's work, which no metric's time includes.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from gatebench import cells, check, system, traffic

# top-level module names the process must not hold once the window closes:
# the JAX package the port was made from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What a metric's reader reads."""

    device: object
    mix: dict
    db: np.ndarray
    pool: np.ndarray
    setup_s: float
    window: system.Window
    build: dict                               # build_seconds + the report
    trace: Optional[object] = None            # trace.Trace of the window
    bounds_ms: dict = field(default_factory=dict)   # hop kernel -> Σ bound


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(torch, cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, log=print, extra=None) -> dict:
    """Run ``cell`` once and return its result's fields (``result_line``
    orders them).  ``device`` may be the CPU (the kernels' plain versions;
    tests) when ``trace`` is off.  ``extra(config, db, state, index, q,
    ids, dists, hops, walk, device)``, where given, is called on the reference's
    sample and its return kept as ``out["extra"]`` (the control's
    readings)."""
    from gatebench.trace import Recorder

    cfg, mix = cell.config, cell.mix
    s = traffic.seeds(seed)
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    if cuda:
        system.build_kernels()
    kernels_s = time.perf_counter() - t0
    db = traffic.database(cfg)
    train_q, pool = traffic.queries(cfg, mix, db, s["order"])
    idx = system.build_index(cfg, db, train_q, device)
    sp = system.search_params(cfg, mix)
    if sp.kernel == "fused_q8":
        idx.ensure_quantized()
    system.warm_batches(torch, idx, sp, pool, device)
    setup_s = time.perf_counter() - t_start

    rec = Recorder(torch) if trace else contextlib.nullcontext()
    with rec:
        window = system.closed_loop(torch, idx, sp, pool, seconds, device)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    system.to_host(window)

    replay = sorted({f for _, mod in cell.per_layer
                     for f in getattr(mod, "REPLAY", ())}) if trace else []
    counts = Counter(a.pool for a in window.answers)
    bounds = system.replay_bounds(torch, idx, sp, pool, counts, replay,
                                  device) if replay else {}
    state = system.index_state(idx)
    build = {**system.build_seconds(idx.build_report),
             "report": idx.build_report}
    del idx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    q, ids, dists, hops = check.sample(window.answers, pool,
                                       mix["check_sample"], s["sample"])
    w = check.walk_of(cfg, mix)
    index = check.reference_index(db, state, cfg["gate"])
    numbers = check.compare(db, index, q, ids, dists, hops, w, device)
    numbers.update(check.graph_numbers(db, state, cfg["nsg"], s["sample"],
                                       device))
    run = Run(device, mix, db, pool, setup_s, window, build,
              getattr(rec, "trace", None), bounds)
    metrics = {}
    for m, mod in (cell.per_layer if trace else cell.end_to_end):
        v = mod.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    ref_s = time.perf_counter() - t_ref

    correct, checks = check.judge(numbers, cell.limits)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    out = {"correct": bool(correct),
           "attempted": sum(len(pool[a.pool]) for a in window.answers),
           "failed": 0,   # a closed loop waits for every answer
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(10),
                            "idle_gaps": run.trace.idle_gaps(window.spans, 10)}
    if extra is not None:
        out["extra"] = extra(cfg, db, state, index, q, ids, dists, hops, w, device)
    out["checks"] = checks
    log(json.dumps({
        "setup_s": setup_s, "kernels_s": kernels_s,
        "window_s": window.seconds, "batches": len(window.answers),
        "reference_s": ref_s,
        "padded_R": int(state["neighbors"].shape[1]),
        "build": {k: v for k, v in build["report"].items()
                  if isinstance(v, (int, float))}}), file=sys.stderr)
    return out


def result_line(out: dict) -> str:
    """The result line's keys in order, ``checks`` (each number compared beside
    its limit) last."""
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if "breakdown" in out:
        keys.append("breakdown")
    return json.dumps({k: out[k] for k in keys + ["checks"]})


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.find_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gatebench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run_cell(torch, cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"), t_start,
                   log=lambda *a, **k: print(*a, **k, flush=True))
    found = forbidden_modules()
    if found:
        print(f"gatebench: the process holds {found} after the window",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        lim = c["limit"]
        lim = (f">= {lim['at_least']!r}" if isinstance(lim, dict)
               else f"<= {lim!r}")
        print(f"check {name} {c['value']!r} limit {lim}", file=sys.stderr)
    print(result_line(out), flush=True)
    return 0
