#!/usr/bin/env python3
"""Time the hop kernels K1 and K2 of csrc/gather_dist.cu against variants
of K2's register bound and against another source, on one CUDA card.

Run from the root of a checkout:
    python3 tools/hop_kernel_probe.py [--other OTHER/gather_dist.cu]
                                      [--bounds 4 5 6 7 8] [--out FILE]

The variants are the port's gather_dist.cu with ``rows_q8_bulk``'s
``__launch_bounds__(kThreads, 5)`` set to each of ``--bounds`` (blocks an
SM), written under build/hop_probe/ and built beside the port's with its
nvcc flags; each one's ptxas register and spill lines are printed.  Each
width d (128, 512, 960) gets an N x d database of N(0, 1) rows (seed 0)
and three id sets (B, 247) of one density each, valid ids uniform over
the rows, the rest -1:

  dense   (1024, 247), 90% valid: phase 18's width records
  busy    (10,000, 247), 13% valid: the 10,000-query search's first hops
          (~325,000 valid slots a call in chip_smoke.py's hop phase)
  tail    (10,000, 247), 0.45% valid: its median call (~11,000)

At each point K1 (l2) of the port and of ``--other``, and K2 (l2) of the
port, of each variant and of ``--other``, are held against the plain
version (the port and the variants bit for bit, ``--other`` within rtol =
atol = 1e-5, its equal bits recorded) and timed (median of 30 CUDA-event
calls, each source in turn, twice).  One JSON line a point; the whole
record to ``--out``.
"""
import argparse
import importlib
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = {128: 1_000_000, 512: 250_000, 960: 100_000}
DENSITIES = {"dense": (1024, 0.90), "busy": (10_000, 0.13),
             "tail": (10_000, 0.0045)}
R = 247
BOUND = "__launch_bounds__(kThreads, 5)\nrows_q8_bulk("


def variant(src: Path, blocks: int, where: Path) -> Path:
    """The port's source (and its headers) under ``where``/v<blocks>/, with
    K2's bulk kernel bounded to ``blocks``."""
    text = src.read_text()
    if text.count(BOUND) != 1:
        raise SystemExit(f"{src}: K2's launch bound not found")
    out = where / f"v{blocks}"
    out.mkdir(parents=True, exist_ok=True)
    for h in src.parent.glob("*.cuh"):
        (out / h.name).write_text(h.read_text())
    (out / src.name).write_text(text.replace(
        BOUND, BOUND.replace(", 5)", f", {blocks})")))
    return out / src.name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--bounds", type=int, nargs="*", default=[4, 5, 6, 7, 8])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("hop_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.quant import quantize_db

    # the wrapper module (the package exports its gather_dist function)
    gd = importlib.import_module("repro_torch.kernels.gather_dist")
    dev = torch.device("cuda")
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip())
    _build.build(["gather_dist"])
    cs.log_ptxas("port", _build.build_logs["gather_dist"])
    src = ROOT / "src" / "repro_torch" / "csrc" / "gather_dist.cu"
    paths = {f"v{b}": variant(src, b, ROOT / "build" / "hop_probe")
             for b in args.bounds}
    if args.other is not None:
        paths["other"] = args.other
    with ThreadPoolExecutor(len(paths) or 1) as pool:  # one nvcc each
        jobs = {tag: pool.submit(cs.load_baseline, p)
                for tag, p in paths.items()}
    k1 = {"port": gd.gather_rows_dist}
    k2 = {"port": gd.gather_rows_dist_q8}
    for tag, job in jobs.items():
        lib, blog = job.result()
        cs.log_ptxas(tag, blog)
        k2[tag] = cs.baseline_kernel(lib, gd, "gather_rows_dist_q8")
        if tag == "other":
            k1[tag] = cs.baseline_kernel(lib, gd, "gather_rows_dist")

    records = []
    for d, n in WIDTHS.items():
        rng = np.random.default_rng(0)
        db = rng.standard_normal((n, d), dtype=np.float32)
        qdb = quantize_db(db).to(dev)
        dbt = torch.as_tensor(db, device=dev)
        dp = qdb.codes.shape[1]
        for density, (B, p_valid) in DENSITIES.items():
            q = torch.as_tensor(rng.standard_normal((B, d), dtype=np.float32),
                                device=dev)
            qp = torch.zeros((B, dp), device=dev)
            qp[:, :d] = q
            ids = rng.integers(0, n, (B, R)).astype(np.int32)
            ids[rng.random((B, R)) >= p_valid] = -1
            ids = torch.as_tensor(ids, device=dev)
            rec = {"d": d, "N": n, "density": density, "shape": [B, R],
                   "valid_slots": int((ids >= 0).sum()), "k1_us": {},
                   "k2_us": {}}
            for key, fns, plain, a in (
                ("k1_us", k1, ref.gather_rows_dist_ref, (dbt, q)),
                ("k2_us", k2, ref.gather_rows_dist_q8_ref,
                 (qdb.codes, qdb.scale, qdb.zero, qp)),
            ):
                want = plain(ids, *a)
                for tag, fn in fns.items():
                    got = fn(ids, *a)
                    torch.cuda.synchronize()
                    same = torch.equal(got, want)
                    cs.require(same or tag == "other" and bool(torch.allclose(
                        got, want, rtol=1e-5, atol=1e-5)),
                        f"{tag} {key[:2]} at d = {d} ({density}) disagrees "
                        "with the plain version")
                    rec[f"{key[:2]}_{tag}_equal_bits"] = same
                times = {tag: [] for tag in fns}
                for _ in range(2):
                    for tag, fn in fns.items():
                        times[tag].append(1e3 * cs.cuda_ms(
                            torch, lambda i, fn=fn: fn(ids, *a)))
                rec[key] = times
                rec[key + "_median"] = {t: statistics.median(v)
                                        for t, v in times.items()}
            cs.log(json.dumps(rec))
            records.append(rec)
        del db, dbt, qdb
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
