"""§Roofline aggregation: dry-run JSONs → three-term roofline table
(counterpart of ``repro.launch.roofline``).

    python -m repro_torch.launch.roofline [--dir experiments/dryrun] [--mesh 16x16]

Terms (seconds per step, PER DEVICE — the op record holds each rank's
local shapes), against one "NVIDIA H100 80GB HBM3, 700.00 W" (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``):
    compute    = dot_flops / PEAK_FLOPS     (989 TFLOP/s dense bf16)
    memory     = hbm_bytes_fused / HBM_BW   (3.35 TB/s HBM3)
    collective = collective_bytes / LINK_BW (50 GB/s: a 16-wide mesh axis
                 spans two 8-GPU nodes, so its slowest link is the node's
                 400 Gb/s InfiniBand port a GPU; the "pod" axis crosses
                 the same network)

The three constants are NVIDIA's published figures (H100 SXM5 datasheet
for the FLOP and HBM rates, DGX H100 datasheet for one ConnectX-7 400 Gb/s
port a GPU), not measurements; ``chip_smoke.py`` prints the card's achieved
matmul and copy rates beside them.  dot_flops/hbm_bytes/collective_bytes
come from the op analysis (``launch.trace_analysis``).  MODEL_FLOPS is the
analytic 6·N_active·D (train) / 2·N_active (serve) count; its ratio to the
traced FLOPs exposes remat/dispatch waste.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

PEAK_FLOPS = 989e12     # dense bf16 per card, H100 SXM5 datasheet
HBM_BW = 3.35e12        # bytes/s per card, H100 SXM5 80GB HBM3 datasheet
LINK_BW = 50e9          # bytes/s per card: one 400 Gb/s InfiniBand port
HBM_GIB = 80.0          # device memory a card


def load_cells(dir_: str, mesh: str, reanalyze: bool = True) -> List[dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        r = json.load(open(f))
        if not isinstance(r, dict):  # e.g. a previously-written roofline table
            continue
        if r.get("mesh") != mesh or not r.get("ok") or r.get("skipped"):
            continue
        if "hlo" not in r:
            continue
        side = f[: -len(".json")] + ".trace.json.gz"
        if reanalyze and os.path.exists(side):
            import gzip

            from repro_torch.launch.trace_analysis import analyze_trace

            with gzip.open(side, "rt") as fh:
                r["hlo"] = analyze_trace(json.load(fh))
        out.append(r)
    return out


def roofline_row(r: dict) -> dict:
    h = r["hlo"]
    n_dev = r.get("n_devices", 256)
    t_c = h["dot_flops"] / PEAK_FLOPS
    # the memory term uses the fusion-adjusted byte count when available
    # (pricing every elementwise op separately models a fusion-less machine)
    t_m = h.get("hbm_bytes_fused", h["hbm_bytes"]) / HBM_BW
    t_x = h["collective_bytes"] / LINK_BW
    dominant = max(
        (("compute", t_c), ("memory", t_m), ("collective", t_x)),
        key=lambda kv: kv[1],
    )[0]
    model_flops = r.get("model_flops") or 0.0
    mf_per_dev = model_flops / n_dev
    ratio = mf_per_dev / h["dot_flops"] if h["dot_flops"] else 0.0
    bound = max(t_c, t_m, t_x)
    # roofline fraction: useful model compute vs the time the dominant
    # term pins the step at (1.0 = the step is pure useful compute at peak)
    frac = (mf_per_dev / PEAK_FLOPS) / bound if bound else 0.0
    mem_gib = (
        r.get("argument_size_in_bytes", 0) + r.get("temp_size_in_bytes", 0)
        + r.get("output_size_in_bytes", 0) - r.get("alias_size_in_bytes", 0)
    ) / 2**30
    return {
        "arch": r["arch"],
        "shape": r["shape"],
        "mesh": r["mesh"],
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "dominant": dominant,
        "model_flops": model_flops,
        "hlo_flops_per_dev": h["dot_flops"],
        "useful_ratio": ratio,
        "roofline_fraction": frac,
        "mem_gib_per_dev": mem_gib,
        "fits_hbm": mem_gib <= HBM_GIB,
        "collectives": {
            k: v["bytes"] for k, v in h.get("collectives", {}).items()
        },
        "fallbacks": len(r.get("fallbacks", [])),
    }


def suggest(row: dict) -> str:
    d = row["dominant"]
    if not row["fits_hbm"]:
        return (f"OOM at {HBM_GIB:.0f} GiB — raise microbatching / remat / "
                "reshard first")
    if d == "compute":
        if row["useful_ratio"] < 0.4:
            return "compute-bound with low useful ratio — cut remat/dense-MoE waste"
        return "compute-bound — already near the right wall; overlap collectives"
    if d == "memory":
        return "memory-bound — fuse/reuse activations, widen arithmetic intensity"
    return "collective-bound — reshard to cut all-gather volume / overlap with compute"


def render_markdown(rows: List[dict]) -> str:
    hdr = (
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "useful ratio | roofline frac | GiB/dev | next move |\n"
        "|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3g} | "
            f"{r['memory_s']:.3g} | {r['collective_s']:.3g} | "
            f"{r['dominant']} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2f} | {r['mem_gib_per_dev']:.1f}"
            f"{'' if r['fits_hbm'] else ' ⚠'} | {suggest(r)} |"
        )
    return hdr + "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = [roofline_row(r) for r in load_cells(args.dir, args.mesh)]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    md = render_markdown(rows)
    print(md)
    out = args.out or os.path.join(args.dir, f"roofline_{args.mesh}.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"-> {out}")


if __name__ == "__main__":
    main()
