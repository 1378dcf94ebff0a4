"""The system under test, ``repro_torch``, as one cell drives it.

The only module of the benchmark that imports the program: it builds the
index from a configuration, drives it with a mix (a closed loop through
``GateIndex.search``), and hands back the answers and the build's own
stage timers.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List

import numpy as np


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels() -> None:
    """Compile whatever the checkout's kernel cache lacks (the first run in
    a checkout), all sources at once."""
    from repro_torch.kernels import _build

    _build.build()


def build_index(cfg: dict, db: np.ndarray, train_q: np.ndarray, device):
    """``GateIndex.build`` with the configuration's NSG and GATE settings."""
    from repro_torch import GateConfig, GateIndex

    gcfg = GateConfig(n_hubs=cfg["n_hubs"], **cfg["gate"])
    return GateIndex.build(db, train_q, gcfg, device=device, **cfg["nsg"])


def search_params(cfg: dict, mix: dict):
    from repro_torch import SearchParams

    return SearchParams(**{**cfg["search"], **mix.get("search", {})})


def index_state(idx) -> dict:
    """What the reference takes of the build (numpy): the graph, its
    navigating node, the hubs' rows and both towers' trained weights."""
    return {
        "neighbors": np.asarray(idx.neighbors),
        "enter_id": int(idx.enter_id),
        "hub_ids": np.asarray(idx.hubs.ids),
        "tower": {k: v.detach().cpu().numpy()
                  for k, v in idx.tower_params.as_dict().items()},
    }


def build_seconds(report: dict) -> dict:
    """The build's stage timers: the NSG, and GATE's five stages."""
    return {"nsg_s": report["t_nsg"],
            "gate_s": sum(report[k] for k in ("t_hubs", "t_topo", "t_samples",
                                                 "t_train", "t_nav"))}


@dataclass
class Answer:
    """One batch: which pool batch, when, and what came back."""

    pool: int
    sent: float                # host s
    done: float                # host s: the answers were in
    result: object             # SearchResult (device), then host arrays


@dataclass
class Window:
    answers: List[Answer]
    t0: float
    t1: float
    spans: list                # (start ns, end ns, label)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def warm_batches(torch, idx, sp, pool, device) -> None:
    """One search of the first pool batch at the cell's parameters."""
    idx.search(pool[0], params=sp, telemetry_sink=None, device=device)
    sync(torch, device)


def closed_loop(torch, idx, sp, pool, seconds: float, device) -> Window:
    """Pool batches back to back, in order, until ``seconds`` have passed;
    the batch in flight then completes and the window ends with it."""
    answers, spans = [], []
    t0 = time.perf_counter()
    i = 0
    while True:
        ts = time.perf_counter()
        res = idx.search(pool[i % len(pool)], params=sp, telemetry_sink=None,
                         device=device)
        sync(torch, device)
        te = time.perf_counter()
        answers.append(Answer(i % len(pool), ts, te, res))
        spans.append((int(ts * 1e9), int(te * 1e9), "in a batch"))
        i += 1
        if te - t0 >= seconds:
            break
    return Window(answers, t0, answers[-1].done, spans)


def to_host(window: Window) -> None:
    """Each answer's ids, distances, hops and distance evaluations as
    numpy arrays."""
    for a in window.answers:
        r = a.result
        a.result = {"ids": r.ids.cpu().numpy(), "dists": r.dists.cpu().numpy(),
                    "hops": r.hops.cpu().numpy(),
                    "evals": r.dist_evals.cpu().numpy()}


def replay_bounds(torch, idx, sp, pool, counts: dict, functions, device) -> dict:
    """Σ of each hop kernel's bound (ms) over the window's calls: each pool
    batch the window searched is searched once more with ``record_bounds``
    on the names the search looks up, and its bounds count as often as the
    window searched it."""
    import contextlib

    from repro_torch.graphs import search as S

    from gatebench.yardstick import record_bounds

    out = dict.fromkeys(functions, 0.0)
    for b, times in counts.items():
        with contextlib.ExitStack() as stack:
            bounds = {name: stack.enter_context(record_bounds(torch, S, name))
                      for name in functions}
            idx.search(pool[b], params=sp, telemetry_sink=None, device=device)
            sync(torch, device)
        for name in functions:
            out[name] += times * sum(x["bound_ms"] for x in bounds[name])
    return out
