"""Inline the §Roofline table into EXPERIMENTS.md from the dry-run JSONs
(counterpart of ``repro.launch.fill_experiments``).

    python -m repro_torch.launch.fill_experiments [--dir experiments/dryrun]
        [--doc EXPERIMENTS.md]
"""
from __future__ import annotations

import argparse
import json
import os
import re

from repro_torch.launch.roofline import (
    HBM_GIB, load_cells, render_markdown, roofline_row,
)

MARK = "<!-- ROOFLINE_TABLE -->"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--doc", default="EXPERIMENTS.md")
    args = ap.parse_args(argv)
    rows = [roofline_row(r) for r in load_cells(args.dir, "16x16")]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    md = render_markdown(rows)
    n_fit = sum(r["fits_hbm"] for r in rows)
    summary = (
        f"\n{len(rows)} baseline cells on the 16×16 mesh; {n_fit}/{len(rows)} "
        f"fit {HBM_GIB:.0f} GiB HBM (⚠ marks the rest — per-cell notes in "
        "the table; the multi-pod 2×16×16 pass is recorded in "
        f"`{args.dir}/*2x16x16.json`).\n\n"
    )
    with open(args.doc) as f:
        text = f.read()
    block = MARK + "\n" + summary + md
    if MARK in text:
        # replace from marker to the next '---' horizontal rule
        pat = re.compile(re.escape(MARK) + r".*?(?=\n---)", re.S)
        text = pat.sub(lambda _: block, text, count=1)
    with open(args.doc, "w") as f:
        f.write(text)
    with open(os.path.join(args.dir, "roofline_16x16.json"), "w") as f:
        json.dump(rows, f, indent=1)
    print(f"inlined {len(rows)} rows into {args.doc}")


if __name__ == "__main__":
    main()
