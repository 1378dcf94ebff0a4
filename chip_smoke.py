#!/usr/bin/env python3
"""Drive the repro_torch main path on one CUDA card and check it.

Run from the root of a checkout:
    python3 chip_smoke.py  [--n N] [--queries Q] [--out FILE]

1. Print the card and its power limit; build the CUDA kernels from
   src/repro_torch/csrc with nvcc (all sources in parallel).
2. Kernel phase: every kernel of the main path against its plain PyTorch
   version on the card, at the main path's shapes (K1/K2: 1024 queries x 32
   ids into the N x 128 database, ~10% invalid ids, both metrics; K3: Q
   queries x 64 hubs x 128 dims), and timed beside its bound.
3. Build a GATE index over a synthetic SIFT-shaped database (N x 128,
   default N = 1,000,000) with the default GateConfig, on the card.
4. Search Q held-out queries (default 10,000), k = 10: GATE with the
   xla / fused / fused_q8 kernels and the medoid baseline; recall@10 against
   exact ground truth, QPS, and the mean telemetry of one instrumented run.
5. Cosine search with fused and fused_q8 on the same index.
6. One fused search under torch.profiler: the device's busy and idle share.

Every check that fails raises, so the script exits non-zero and prints no
result.  The last line is the JSON result object; the line before it lists
every kernel.  ``--out FILE`` also writes the full record there as JSON.
Exits non-zero without a CUDA card or outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and fp32
# throughput outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(*parts) -> None:
    print(*parts, flush=True)


def bound(bytes_moved: float, ops: float) -> dict:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "ops": ops}


def cuda_ms(torch, fn, reps: int = 30) -> float:
    """Median device time of ``fn(i)`` over ``reps`` calls, in ms.

    A sleep kernel keeps the card busy while the host enqueues every call,
    so each CUDA-event pair brackets the device work of one call and not the
    host's launch overhead (tens of microseconds per Python call)."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)  # ~50 ms of device time
    for i, (s, e) in enumerate(events):
        s.record()
        fn(i)
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def kernel_phase(torch, np, db, queries, dev, n_hubs: int = 64) -> dict:
    """Each kernel against its plain version on the card; times and bounds."""
    from repro_torch.kernels import (
        gather_rows_dist, gather_rows_dist_q8, ref, twotower_score,
    )
    from repro_torch.quant import quantize_db

    N, d = db.shape
    B, R, reps = min(1024, len(queries)), 32, 30
    rng = np.random.default_rng(11)
    ids_np = rng.integers(0, N, (reps + 3, B, R)).astype(np.int32)
    ids_np[rng.random(ids_np.shape) < 0.1] = -1
    ids_all = torch.as_tensor(ids_np, device=dev)   # one fresh id set per rep
    dbt = torch.as_tensor(db, device=dev)
    q = torch.as_tensor(queries[:B], device=dev)
    qn = q / torch.clamp_min(torch.linalg.norm(q, dim=1, keepdim=True), 1e-9)
    inv = 1.0 / torch.clamp_min(torch.linalg.norm(dbt, dim=1), 1e-9)
    t0 = time.perf_counter()
    qdb = quantize_db(db).to(dev)
    log(f"quantize_db {N}x{d}: {time.perf_counter() - t0:.2f} s")
    dp, nb = qdb.codes.shape[1], qdb.scale.shape[1]
    qp = torch.zeros((B, dp), device=dev)
    qp[:, :d] = q
    qnp = torch.zeros((B, dp), device=dev)
    qnp[:, :d] = qn
    out = {}

    def check(name, got, want, ids):
        torch.cuda.synchronize()
        bad = ids < 0
        require(bool(torch.all(got[bad] == want[bad])) and
                bool(torch.all(got[bad] == np.float32(3.4e38))),
                f"{name}: invalid slots are not exactly 3.4e38")
        ok = torch.isclose(got[~bad], want[~bad], rtol=1e-5, atol=1e-5)
        require(bool(ok.all()), f"{name}: kernel disagrees with its plain version")
        return float((got[~bad] - want[~bad]).abs().max())

    n_valid = float((ids_all[:reps] >= 0).sum()) / reps
    for name, fn, plain, args_l2, args_cos, row_bytes in (
        ("gather_rows_dist", gather_rows_dist, ref.gather_rows_dist_ref,
         (dbt, q), (dbt, qn, inv), 4 * d),
        ("gather_rows_dist_q8", gather_rows_dist_q8, ref.gather_rows_dist_q8_ref,
         (qdb.codes, qdb.scale, qdb.zero, qp),
         (qdb.codes, qdb.scale, qdb.zero, qnp, qdb.inv_norms), dp + 8 * nb),
    ):
        rec = {}
        for metric, args in (("l2", args_l2), ("cosine", args_cos)):
            err = check(f"{name}/{metric}", fn(ids_all[0], *args),
                        plain(ids_all[0], *args), ids_all[0])
            ms = cuda_ms(torch, lambda i: fn(ids_all[i], *args), reps)
            plain_ms = cuda_ms(torch, lambda i: plain(ids_all[i], *args), reps)
            width = args[-2 if metric == "cosine" else -1].shape[1]
            b = bound(n_valid * (row_bytes + (4 if metric == "cosine" else 0))
                      + B * R * 8 + B * width * 4,
                      n_valid * width * 3)
            rec[metric] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}
        out[name] = rec

    # query latents and hub reps stand in at the main path's (Q, 128) x (64, 128)
    zq = torch.as_tensor(np.ascontiguousarray(queries[:, :d]), device=dev)
    hubs = torch.as_tensor(db[rng.choice(N, n_hubs, replace=False)], device=dev)
    got = twotower_score(zq, hubs)
    want = ref.twotower_score_ref(zq, hubs)
    torch.cuda.synchronize()
    require(bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5)),
            "twotower_score: kernel disagrees with its plain version")
    err = float((got - want).abs().max())
    Bq = zq.shape[0]
    cos_lib = torch.nn.functional.cosine_similarity
    out["twotower_score"] = {"score": {
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda i: twotower_score(zq, hubs)),
        "plain_ms": cuda_ms(torch, lambda i: ref.twotower_score_ref(zq, hubs)),
        "library_ms": cuda_ms(
            torch, lambda i: cos_lib(zq[:, None, :], hubs[None, :, :], dim=-1)),
        **bound((Bq * d + n_hubs * d + Bq * n_hubs) * 4,
                2 * Bq * n_hubs * d + 2 * (Bq + n_hubs) * d),
    }}
    return out


def search_phase(torch, idx, eval_q, gt, metric, kernels, baseline, dev):
    from repro_torch import SearchParams, recall_at_k, summarize

    qd = torch.as_tensor(eval_q, device=dev)
    rows = {}
    runs = [(f"gate/{k}", k, "gate") for k in kernels]
    if baseline:
        runs.append(("baseline_medoid/fused", "fused", "baseline"))
    for label, kernel, how in runs:
        sp = SearchParams(k=10, beam_width=64, max_hops=256, metric=metric,
                          kernel=kernel, rerank_mult=4)

        def run(p):
            if how == "gate":
                return idx.search(qd, params=p, device=dev)
            return idx.search_baseline(qd, params=p, entry="medoid", device=dev)

        run(sp)  # warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(sp)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _, tele = run(sp.replace(instrument=True))
        s = summarize(tele)
        ids = res.ids.cpu().numpy()
        rows[label] = {
            "recall_at_10": recall_at_k(ids, gt, 10) if gt is not None else None,
            "qps": len(eval_q) / secs, "seconds": secs,
            "mean_hops": s["mean_hops"], "mean_dist_evals": s["mean_dist_evals"],
            "mean_bytes_read": s["mean_bytes_read"],
            "mean_nav_hops": s["mean_nav_hops"], "ids": ids,
        }
        log(f"search {metric} {label}: " + json.dumps(
            {k: v for k, v in rows[label].items() if k != "ids"}))
    return rows


def profile_search(torch, idx, eval_q, dev, wall_s: float) -> dict:
    """One ``fused`` l2 search under ``torch.profiler``: device kernel time
    (summed over kernels; one stream, so they do not overlap) against the
    unprofiled wall time of the same search, and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import SearchParams

    qd = torch.as_tensor(eval_q, device=dev)
    sp = SearchParams(k=10, beam_width=64, max_hops=256, kernel="fused")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        idx.search(qd, params=sp, device=dev)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_s = sum(e.self_device_time_total for e in kern) * 1e-6
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "device_busy_s": busy_s if kern else None,
        "wall_s": wall_s,
        "device_idle_share": (1.0 - busy_s / wall_s) if kern else None,
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": e.self_device_time_total * 1e-3}
                        for e in top],
    }


def agreement(a, b) -> float:
    return float((a == b).mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="database rows")
    ap.add_argument("--queries", type=int, default=10_000,
                    help="training queries and evaluation queries, each")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the full record to this JSON file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from repro_torch import GateConfig, GateIndex, exact_knn
    from repro_torch import kernels as K
    from repro_torch.data.synthetic import make_database, train_eval_query_split
    from repro_torch.kernels import _build

    # 1. build every kernel
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
        + json.dumps({k: round(v, 2) for k, v in secs.items()}))
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # data
    t0 = time.perf_counter()
    db, _ = make_database("sift10m-like", args.n, seed=0)
    train_q, eval_q = train_eval_query_split(db, args.queries, args.queries)
    log(f"data: db {db.shape} train {train_q.shape} eval {eval_q.shape} "
        f"{time.perf_counter() - t0:.2f} s")

    # 2. kernel phase
    kres = kernel_phase(torch, np, db, eval_q, dev)
    for name, rec in kres.items():
        log(f"kernel {name}: " + json.dumps(rec))

    # 3. build the index on the card
    t0 = time.perf_counter()
    idx = GateIndex.build(db, train_q, GateConfig(), R=32, knn_k=32,
                          search_l=64, pool_size=96, device=dev)
    t_build = time.perf_counter() - t0
    rep = idx.build_report
    log(f"build: {t_build:.2f} s " + json.dumps(
        {k: (round(v, 3) if isinstance(v, float) else v) for k, v in rep.items()}))
    t0 = time.perf_counter()
    idx.ensure_quantized()
    log(f"ensure_quantized: {time.perf_counter() - t0:.2f} s")
    log("memory_bytes: " + json.dumps(idx.memory_bytes()))
    require(rep["loss_last"] < rep["loss_first"], "two-tower loss did not fall")

    t0 = time.perf_counter()
    gt, _ = exact_knn(eval_q, db, 10, device=dev)
    log(f"ground truth exact_knn {eval_q.shape[0]} x {db.shape[0]}: "
        f"{time.perf_counter() - t0:.2f} s")

    # 4-5. the main path: search; counts from here to the end of phase 5
    K.reset_launch_counts()
    l2 = search_phase(torch, idx, eval_q, gt, "l2",
                      ("xla", "fused", "fused_q8"), baseline=True, dev=dev)
    cos = search_phase(torch, idx, eval_q, None, "cosine",
                       ("xla", "fused", "fused_q8"), baseline=False, dev=dev)
    launches = K.launch_counts()
    log("launches on the main path: " + json.dumps(launches))
    prof = profile_search(torch, idx, eval_q, dev, l2["gate/fused"]["seconds"])
    log("profile gate/fused l2: " + json.dumps(prof))

    agree_l2 = agreement(l2["gate/fused"]["ids"], l2["gate/xla"]["ids"])
    agree_cos = agreement(cos["gate/fused"]["ids"], cos["gate/xla"]["ids"])
    r = {k: v["recall_at_10"] for k, v in l2.items()}
    log("checks: " + json.dumps({"fused_vs_xla_l2": agree_l2,
                                 "fused_vs_xla_cosine": agree_cos,
                                 "recall_at_10": r}))
    require(agree_l2 >= 0.999, f"fused ids agree with xla on {agree_l2:.5f} < 0.999")
    require(agree_cos >= 0.999,
            f"cosine fused ids agree with xla on {agree_cos:.5f} < 0.999")
    require(r["gate/fused_q8"] >= r["gate/fused"] - 0.005,
            "fused_q8 recall@10 below fused - 0.005")
    require(r["gate/fused"] >= r["baseline_medoid/fused"] - 0.02,
            "GATE recall@10 below the medoid baseline - 0.02")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    for rows in (l2, cos):
        for v in rows.values():
            require(v["ids"].shape == (len(eval_q), 10)
                    and (v["ids"] >= 0).all(), "search returned invalid ids")

    sources = {"gather_rows_dist": "src/repro_torch/csrc/gather_dist.cu",
               "gather_rows_dist_q8": "src/repro_torch/csrc/gather_dist.cu",
               "twotower_score": "src/repro_torch/csrc/twotower_score.cu"}
    replaces = {"gather_rows_dist": "src/repro/kernels/gather_dist.py:129",
                "gather_rows_dist_q8": "src/repro/kernels/gather_dist.py:205",
                "twotower_score": "src/repro/kernels/twotower_score.py:40"}
    line = []
    for name in ("gather_rows_dist", "gather_rows_dist_q8", "twotower_score"):
        rec = kres[name]
        main_rec = rec.get("l2", rec.get("score"))
        entry = {
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(v["max_abs_err"] for v in rec.values()),
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": main_rec.get("library_ms"),
        }
        if name == "twotower_score":
            entry["library_call"] = "torch.nn.functional.cosine_similarity"
        else:
            entry["library_note"] = "no single PyTorch call gathers rows and scores them"
            entry["cosine"] = {k: rec["cosine"][k] for k in
                               ("ms", "plain_ms", "bound_ms", "max_abs_err")}
        line.append(entry)

    record = {
        "card": smi, "n": args.n, "queries": args.queries,
        "kernel_build_s": secs, "kernels": kres, "build_s": t_build,
        "build_report": rep, "memory_bytes": idx.memory_bytes(),
        "search_l2": {k: {kk: vv for kk, vv in v.items() if kk != "ids"}
                      for k, v in l2.items()},
        "search_cosine": {k: {kk: vv for kk, vv in v.items() if kk != "ids"}
                          for k, v in cos.items()},
        "agreement": {"l2": agree_l2, "cosine": agree_cos},
        "launches": launches, "profile_fused_l2": prof,
        "seconds": time.perf_counter() - t_start,
    }
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1, default=str))
    log(f"total {record['seconds']:.1f} s")
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
