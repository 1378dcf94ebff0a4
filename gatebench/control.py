"""The control of ``correct``, read on the card at a cell's own size.

    python gatebench/control.py --workload <cell> --seeds 101 102 103 \
        --seconds 5 [--out control-<cell>.json]

For each seed, in one process: the cell's set-up and a short window at its
own load, then the numbers ``correct`` compares for the program's sample
(sound readings), and for the same queries answered by the reference put
in the program's place:

- ``control_bf16``: the reference computed in bfloat16, the precision
  below the configuration's float32 (the towers, every distance);
- ``state_unchanged``: a search that returns the beam as its entry left
  it (no expansion);
- ``half_left_out``: the first half of the sample unanswered;
- ``answer_altered``: each answer's last id replaced by another row;
- ``towers_untrained``: the towers' weights drawn fresh and never
  trained (as ``GateConfig(use_contrastive=False)`` leaves them), the
  answers the reference's on them;
- ``graph_random``: each row's first ``R`` edges replaced by random rows.

Every sound reading lies within its limit, and each of these lies
outside one limit at least: over a most, or under a least
(``sample_recall``).  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from gatebench import bench, cells, check  # noqa: E402
from gatebench.reference import walk  # noqa: E402

FAULTS = ("control_bf16", "state_unchanged", "half_left_out",
          "answer_altered", "towers_untrained", "graph_random")


def _untrained(tower: dict) -> dict:
    """Fresh weights of the towers' shapes: normal with the fan-average
    variance (Glorot), zero biases."""
    g = np.random.default_rng(0)
    return {k: (np.zeros(v.shape, np.float32) if v.ndim == 1 else
                (g.standard_normal(v.shape) * np.sqrt(
                    2.0 / (np.prod(v.shape[:-1]) + v.shape[-1]))).astype(
                        np.float32))
            for k, v in tower.items()}


def _faulty_build(cfg, db, state, index, q, w, device, **change) -> dict:
    """The numbers of a build with ``change`` (state fields): its graph's
    guarantees, and the reference's answers on it judged against it."""
    st = dict(state, **change)
    ix = (replace(index, tower=st["tower"]) if "tower" in change
          else check.reference_index(db, st, cfg["gate"]))
    ids, d, h = walk.search(db, ix, q, w, device=device)
    return {**check.compare(db, ix, q, ids, d, h, w, device),
            **check.graph_numbers(db, st, cfg["nsg"], 0, device)}


def readings(cfg, db, state, index, q, ids, dists, hops, w, device) -> dict:
    """The numbers of the control and of each fault on the sample's
    queries."""
    import torch

    truth = check.knn.exact_knn(db, q, w.k, device=device)

    def numbers(i, d, h):
        return check.compare(db, index, q, i, d, h, w, device, truth)

    r_ids, r_d, r_h = walk.search(db, index, q, w, device=device)
    out = {"control_bf16": numbers(*walk.search(db, index, q, w, device=device,
                                                dtype=torch.bfloat16))}
    e = walk.entries(index, torch.as_tensor(q, device=device),
                     torch.float32).cpu().numpy()
    u_ids = np.full_like(r_ids, -1)
    u_ids[:, 0] = e
    u_d = np.full_like(r_d, 3.4e38)
    u_d[:, 0] = ((db[e] - q) ** 2).sum(axis=1)
    out["state_unchanged"] = numbers(u_ids, u_d, np.zeros_like(r_h))
    half = len(q) // 2
    h_ids, h_d, h_h = r_ids.copy(), r_d.copy(), r_h.copy()
    h_ids[:half], h_d[:half], h_h[:half] = -1, 3.4e38, 0
    out["half_left_out"] = numbers(h_ids, h_d, h_h)
    a_ids = r_ids.copy()
    a_ids[:, -1] = (a_ids[:, -1] + 1) % len(db)
    out["answer_altered"] = numbers(a_ids, r_d, r_h)
    out["towers_untrained"] = _faulty_build(
        cfg, db, state, index, q, w, device,
        tower=_untrained(state["tower"]))
    nb, R = state["neighbors"], cfg["nsg"]["R"]
    rnd = nb.copy()
    rnd[:, :R] = np.random.default_rng(1).integers(0, len(db), (len(db), R))
    out["graph_random"] = _faulty_build(cfg, db, state, index, q, w, device,
                                        neighbors=rnd)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    cell = cells.find_cell(args.workload)
    rows = []
    for seed in args.seeds:
        out = bench.run_cell(torch, cell, seed, args.seconds, False,
                             torch.device("cuda"), time.perf_counter(),
                             extra=readings,
                             log=lambda *a, **k: print(*a, **k, flush=True))
        row = {"seed": seed, "correct": out["correct"],
               "sound": {k: c["value"] for k, c in out["checks"].items()},
               **out["extra"]}
        rows.append(row)
        print("control " + json.dumps(row), flush=True)
    names = list(rows[0]["sound"])
    summary = {n: {"sound_max": max(r["sound"][n] for r in rows),
                   "sound_min": min(r["sound"][n] for r in rows),
                   **{f"{k}_min": min(r[k].get(n, np.inf) for r in rows)
                      for k in FAULTS},
                   **{f"{k}_max": max(r[k].get(n, -np.inf) for r in rows)
                      for k in FAULTS}}
               for n in names}
    print("control summary " + json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "rows": rows, "summary": summary},
            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
