#!/usr/bin/env python3
"""Drive the repro_torch main path on one CUDA card and check it.

Run from the root of a checkout:
    python3 chip_smoke.py  [--n N] [--queries Q] [--out FILE]

1. Print the card and its power limit; build the CUDA kernels from
   src/repro_torch/csrc with nvcc (all sources in parallel).
2. Kernel phase: every kernel of the search path against its plain PyTorch
   version on the card, at the search path's shapes (K1/K2: 1024 queries x
   32 ids into the N x 128 database, ~10% invalid ids, both metrics; K3: Q
   queries x 64 hubs x 128 dims), and timed beside its bound.
3. Kernel API path (``repro_torch.kernels.ops``), at the full-mode shapes of
   benchmarks/bench_kernels.py: K5 l2dist 1024 x 8192 x 128, K4 topk_min
   256 x 1024 (k = 32), K6 gather_dist 1024 x 32 x 128 (~10% ids -1), then
   topk_min(l2dist(1024 queries, the first 65,536 db rows), 10) against
   exact_knn, and again on the last 1024 queries and 65,536 rows.  Driven
   once with the launch counts at 0, then each kernel held against its
   plain version and timed beside its bound.
4. Build a GATE index over a synthetic SIFT-shaped database (N x 128,
   default N = 1,000,000) with the default GateConfig, on the card.
5. Search Q held-out queries (default 10,000), k = 10: GATE with the
   xla / fused / fused_q8 kernels and the medoid baseline; recall@10 against
   exact ground truth, QPS, and the mean telemetry of one instrumented run.
6. Cosine search with fused and fused_q8 on the same index.
7. One fused search under torch.profiler: the device's busy and idle share.
8. Serve phase: a ServeDaemon over the index (kernel "fused", batches of
   1024): 16 requests to an adaptive daemon on DEFAULT_LADDER with /metrics
   scraped once, then 16 to a routed daemon with a query log and shadow
   oversearch; every result is held against an unrouted search at its
   rung; per-request latency, QPS, rungs and the hard_frac path.

Phases 3, 5-6 and 8 are each driven with the kernel launch counts set to 0
just before and read just after: K4-K6 must launch in phase 3, K1-K3 in
phases 5-6 and K1/K3 in phase 8.  Every check that fails raises, so the
script exits non-zero and prints no result.  The last line is the JSON
result object; the line before it lists every kernel.  ``--out FILE`` also
writes the full record there as JSON.  Exits non-zero without a CUDA card
or outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
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


def api_phase(torch, np, db, queries, dev, reps: int = 30) -> dict:
    """The kernel API path: K5 l2dist, K4 topk_min and K6 gather_dist
    through ``ops`` at bench_kernels.py's full-mode shapes, and one composed
    exact top-10 over the first 65,536 db rows.  The path is driven once
    with the launch counts at 0 (``launches``); the checks and timings
    after it are not counted."""
    from repro_torch import exact_knn
    from repro_torch import kernels as K
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(12)
    Q, C, D = 1024, 8192, 128
    B, Ck, k = 256, 1024, 32
    Bg, Rg = 1024, 32
    Nc, Qc, kc = 65536, 1024, 10

    def dev_t(a):
        return torch.as_tensor(a, device=dev)

    # a fresh input per timed call, so no call finds the last one's in L2
    lq = dev_t(rng.standard_normal((Q, D), dtype=np.float32))
    lc = dev_t(rng.standard_normal((reps + 3, C, D), dtype=np.float32))
    td = dev_t(rng.standard_normal((reps + 3, B, Ck), dtype=np.float32))
    gv = dev_t(rng.standard_normal((reps + 3, Bg, Rg, D), dtype=np.float32))
    gq = dev_t(rng.standard_normal((Bg, D), dtype=np.float32))
    ids_np = rng.integers(0, 1 << 20, (reps + 3, Bg, Rg)).astype(np.int32)
    ids_np[rng.random(ids_np.shape) < 0.1] = -1
    gi = dev_t(ids_np)
    cq = dev_t(np.ascontiguousarray(queries[:Qc]))
    chunk = dev_t(np.ascontiguousarray(db[:Nc]))

    # the path, counted
    K.reset_launch_counts()
    out_l2 = ops.l2dist(lq, lc[0])
    out_tk = ops.topk_min(td[0], k)
    out_gd = ops.gather_dist(gv[0], gq, gi[0])
    comp_v, comp_i = ops.topk_min(ops.l2dist(cq, chunk), kc)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    out = {"launches": launches}

    def time3(fn, plain, library):
        return {"ms": cuda_ms(torch, fn, reps),
                "plain_ms": cuda_ms(torch, plain, reps),
                "library_ms": cuda_ms(torch, library, reps) if library else None}

    # K5 l2dist: fp32 against the plain version, rtol 2e-5 atol 2e-4
    want = ref.l2dist_ref(lq, lc[0])
    require(bool(torch.allclose(out_l2, want, rtol=2e-5, atol=2e-4)),
            "l2dist: kernel disagrees with its plain version")
    out["l2dist"] = {
        "shape": [Q, C, D], "max_abs_err": float((out_l2 - want).abs().max()),
        **time3(lambda i: ops.l2dist(lq, lc[i]),
                lambda i: ref.l2dist_ref(lq, lc[i]),
                lambda i: torch.cdist(lq, lc[i])),
        **bound((Q * D + C * D + Q * C) * 4,
                2 * Q * C * D + 2 * (Q + C) * D + 3 * Q * C),
        "library_call": "torch.cdist (returns the root, not its square)",
    }
    # K4 topk_min: values and indices equal to the stable sort
    ve, ie = ref.topk_min_ref(td[0], k)
    require(bool(torch.equal(out_tk[1], ie)) and bool(torch.equal(out_tk[0], ve)),
            "topk_min: kernel disagrees with its plain version")
    out["topk_min"] = {
        "shape": [B, Ck, k], "max_abs_err": float((out_tk[0] - ve).abs().max()),
        **time3(lambda i: ops.topk_min(td[i], k),
                lambda i: ref.topk_min_ref(td[i], k),
                lambda i: torch.topk(td[i], k, dim=1, largest=False)),
        **bound(B * Ck * 4 + B * k * 8, B * Ck * k),
        "library_call": "torch.topk(largest=False), timed only: its tie "
                        "order differs",
    }
    # K6 gather_dist: dot form against the plain difference form
    want = ref.gather_dist_ref(gv[0], gq, gi[0])
    bad = gi[0] < 0
    require(bool(torch.all(out_gd[bad] == np.float32(3.4e38))),
            "gather_dist: invalid slots are not exactly 3.4e38")
    require(bool(torch.allclose(out_gd[~bad], want[~bad], rtol=2e-5, atol=2e-4)),
            "gather_dist: kernel disagrees with its plain version")
    n_valid = float((gi[:reps] >= 0).sum()) / reps
    out["gather_dist"] = {
        "shape": [Bg, Rg, D],
        "max_abs_err": float((out_gd[~bad] - want[~bad]).abs().max()),
        **time3(lambda i: ops.gather_dist(gv[i], gq, gi[i]),
                lambda i: ref.gather_dist_ref(gv[i], gq, gi[i]),
                lambda i: torch.cdist(gv[i], gq[:, None, :])),
        **bound(n_valid * D * 4 + Bg * D * 4 + Bg * Rg * 8, n_valid * D * 6),
        "library_call": "torch.cdist of each (R, d) block to its query: the "
                        "nearest single call; it reads every row, masks "
                        "nothing and returns the root",
    }
    # composed: exact top-10 of 1024 queries over 65,536 rows, on the
    # counted set and on a second one (the last 1024 queries and the last
    # 65,536 rows), so the agreement gate has two readings per run
    rec = composed_check(torch, ops, ref, exact_knn, cq, chunk, kc,
                         (comp_v, comp_i))
    comp_d = rec.pop("d")
    rec["ms"] = cuda_ms(
        torch, lambda i: ops.topk_min(ops.l2dist(cq, chunk), kc), 5)
    rec["topk_ms"] = cuda_ms(torch, lambda i: ops.topk_min(comp_d, kc), 5)
    rec["topk_plain_ms"] = cuda_ms(
        torch, lambda i: ref.topk_min_ref(comp_d, kc), 5)
    del comp_d
    second = composed_check(
        torch, ops, ref, exact_knn,
        dev_t(np.ascontiguousarray(queries[len(queries) - Qc:])),
        dev_t(np.ascontiguousarray(db[len(db) - Nc:])), kc)
    del second["d"]
    out["composed_top10"] = {"shape": [Qc, Nc, D, kc], **rec,
                             "second_set": second}
    return out


F32_EPS = 2.0 ** -23


def composed_check(torch, ops, ref, exact_knn, q, c, k, got=None) -> dict:
    """``ops.topk_min(ops.l2dist(q, c), k)`` against its plain version and
    against the repaired ``exact_knn``; raises on a failed check.

    K4 at a row wider than shared memory must equal the plain stable sort of
    the same distances.  K5 and exact_knn (torch.matmul) both take the fp32
    dot form, which loses ~5 digits to cancellation here (|q|^2 ~ 128,
    neighbour distances ~ 0.5), so their ids differ where two distances tie
    within that rounding.  A dot form of length d rounds each distance by
    about err = eps sqrt(d) (|q|^2 + |c|^2); the j-th smallest of two such
    roundings of one row then lie within 2 err of the true j-th, so in
    float64 each slot's two picks must lie within 4 err of each other (with
    the larger |c|^2 of the two), and the two values within 4 err too."""
    if got is None:
        got = ops.topk_min(ops.l2dist(q, c), k)
    comp_v, comp_i = got
    comp_d = ops.l2dist(q, c)
    pv, pi = ref.topk_min_ref(comp_d, k)
    require(bool(torch.equal(comp_i, pi)) and bool(torch.equal(comp_v, pv)),
            f"topk_min at C = {c.shape[0]} disagrees with its plain version")
    gt_i, gt_d = exact_knn(q, c, k, device=q.device)
    gt_it = torch.as_tensor(gt_i, device=q.device).long()
    ci = comp_i.long()
    agree = float((ci == gt_it).float().mean())
    q64, c64 = q.double(), c.double()
    qn, cn = (q64 * q64).sum(1, keepdim=True), (c64 * c64).sum(1)

    def d64(ids):  # float64 difference form of each picked row
        return ((c64[ids] - q64[:, None, :]) ** 2).sum(-1)

    err = F32_EPS * q.shape[1] ** 0.5 * (qn + torch.maximum(cn[ci], cn[gt_it]))
    slot_gap = (d64(ci) - d64(gt_it)).abs() / err
    val_gap = (comp_v.double()
               - torch.as_tensor(gt_d, device=q.device).double()).abs() / err
    full64 = qn - 2.0 * q64 @ c64.T + cn[None, :]
    true_i = torch.sort(full64, dim=1, stable=True).indices[:, :k]
    del full64
    rec = {
        "id_agreement_exact_knn": agree,
        "id_agreement_float64": float((ci == true_i).float().mean()),
        "exact_knn_agreement_float64": float((gt_it == true_i).float().mean()),
        "max_slot_gap_over_err": float(slot_gap.max()),
        "max_value_gap_over_err": float(val_gap.max()),
        "d": comp_d,
    }
    log("composed check: " + json.dumps(
        {key: v for key, v in rec.items() if key != "d"}))
    require(agree >= 0.995,
            f"topk_min(l2dist) ids agree with exact_knn on {agree:.5f} < 0.995")
    require(bool((slot_gap <= 4.0).all()),
            "topk_min(l2dist) ids differ from exact_knn beyond fp32 rounding")
    require(bool((val_gap <= 4.0).all()),
            "topk_min(l2dist) values differ from exact_knn beyond fp32 rounding")
    return rec


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
                return idx.search(qd, params=p, telemetry_sink=None, device=dev)
            return idx.search_baseline(qd, params=p, entry="medoid",
                                       telemetry_sink=None, device=dev)

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


def profile_search(torch, idx, eval_q, dev, wall_s: float, sp=None) -> dict:
    """One search (default: ``fused`` l2, beam 64) under ``torch.profiler``:
    device kernel time (summed over kernels; one stream, so they do not
    overlap) against the unprofiled wall time of the same search, and the
    kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import SearchParams

    qd = torch.as_tensor(eval_q, device=dev)
    if sp is None:
        sp = SearchParams(k=10, beam_width=64, max_hops=256, kernel="fused")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        idx.search(qd, params=sp, telemetry_sink=None, device=dev)
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


def _batches(np, eval_q, n: int, size: int, offset: int):
    """``n`` request batches of ``size`` eval queries, wrapping around."""
    rows = np.arange(offset * size, (offset + n) * size) % len(eval_q)
    return [np.ascontiguousarray(eval_q[rows[i * size:(i + 1) * size]])
            for i in range(n)]


def serve_phase(torch, np, idx, eval_q, dev, n_req: int = 16,
                batch: int = 1024) -> dict:
    """ServeDaemon over the index: an adaptive daemon, then a routed one.

    Every served result is held against ``idx.search`` of its batch at the
    rung it was served at (per side of the split when routed); with both
    router sides at one rung, routed search is bit-equal to the unrouted
    one.  Returns latency, QPS, rungs, the hard_frac path and the checks."""
    from repro_torch import SearchParams
    from repro_torch import kernels as K
    from repro_torch.obs import DEFAULT_LADDER, HardnessRouter, MetricsRegistry
    from repro_torch.serve.daemon import ServeDaemon

    # launches of the two daemons' warm-up and serving, not of the checks
    launches = dict.fromkeys(K.KERNELS, 0)

    def count_launches():
        for name, n in K.launch_counts().items():
            launches[name] += n

    out = {"launches": launches}

    def drive(daemon, batches):
        lat, rungs, res = [], [], []
        for q in batches:
            rungs.append(daemon.controller.params)
            t0 = time.perf_counter()
            res.append(daemon.search(q, timeout=600))
            lat.append(time.perf_counter() - t0)
        return lat, rungs, res

    def loop_iters(tele, groups):
        """Iterations of the lockstep loop: the most hops in each group."""
        hops = np.asarray(tele.hops.cpu() if torch.is_tensor(tele.hops)
                          else tele.hops)
        return sum(int(hops[g].max()) for g in groups if np.size(hops[g]))

    def stats(lat, n_q):
        return {"latency_p50_s": float(np.quantile(lat, 0.5)),
                "latency_p99_s": float(np.quantile(lat, 0.99)),
                "latency_s": lat, "qps": n_q / sum(lat)}

    # (a) adaptive daemon on the default ladder, /metrics scraped once
    daemon = ServeDaemon(idx, ladder=DEFAULT_LADDER, adaptive=True,
                         kernel="fused", batch_size=batch, metrics_port=0,
                         device=dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    port = daemon.start()
    warm_s = time.perf_counter() - t0
    batches = _batches(np, eval_q, n_req, batch, 0)
    try:
        lat, rungs, res = drive(daemon, batches)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as r:
            scrape = r.read().decode()
    finally:
        daemon.stop()
    count_launches()
    require("search_latency_seconds_bucket" in scrape,
            "/metrics has no search_latency_seconds_bucket")
    for q, rung, (r, _) in zip(batches, rungs, res):
        want, _ = idx.search(q, params=rung.params(daemon.base_params),
                             telemetry_sink=None, device=dev)
        require(bool(torch.equal(r.ids, want.ids)),
                f"adaptive daemon ids differ from search at rung {rung}")
    iters = [loop_iters(t, [slice(None)]) for _, t in res]
    out["adaptive"] = {
        "warmup_s": warm_s, **stats(lat, n_req * batch),
        "loop_iters": iters,
        "ms_per_iter": [1e3 * t / n for t, n in zip(lat, iters)],
        "rungs": [[r.beam_width, r.max_hops] for r in rungs],
        "moves": [{k: h[k] for k in ("batch", "from", "to")}
                  for h in daemon.controller.history],
    }
    log("serve adaptive: " + json.dumps(
        {k: v for k, v in out["adaptive"].items() if k != "latency_s"}))

    # (b) routed: both sides at one rung is bit-equal to unrouted search
    base = SearchParams(k=10, instrument=True, kernel="fused")
    same = HardnessRouter(DEFAULT_LADDER, batch_size=batch, easy_level=3,
                          hard_level=3, registry=MetricsRegistry())
    for q in batches[:2]:
        routed, rep = idx.search_routed(q, router=same, params=base,
                                        telemetry_sink=None, device=dev)
        plain, _ = idx.search(q, params=DEFAULT_LADDER[3].params(base),
                              telemetry_sink=None, device=dev)
        require(rep.easy_idx.size > 0 and rep.hard_idx.size > 0,
                "routed check: one side of the split is empty")
        for f in ("ids", "dists", "hops"):
            require(np.array_equal(getattr(routed, f),
                                   getattr(plain, f).cpu().numpy()),
                    f"routed {f} differ from unrouted search at one rung")

    # (b) the routed daemon: query log, shadow oversearch every 4th batch
    qlog = Path(tempfile.mkdtemp(prefix="chip_smoke_")) / "qlog.jsonl"
    daemon = ServeDaemon(idx, ladder=DEFAULT_LADDER, route=True,
                         kernel="fused", batch_size=batch, qlog=str(qlog),
                         shadow_every=4, device=dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    daemon.start()
    warm_s = time.perf_counter() - t0
    batches = _batches(np, eval_q, n_req, batch, n_req)
    fracs, sides = [], []
    try:
        lat, res = [], []
        for q in batches:
            t0 = time.perf_counter()
            res.append(daemon.search(q, timeout=600))
            lat.append(time.perf_counter() - t0)
            fracs.append(daemon.router.hard_frac)
    finally:
        daemon.stop()
    count_launches()
    recs = [json.loads(x) for x in qlog.read_text().splitlines()]
    n_batch_recs = sum(r["kind"] == "batch" for r in recs)
    require(n_batch_recs == n_req,
            f"query log holds {n_batch_recs} batch records, not {n_req}")
    router = daemon.router
    batch_recs = [x for x in recs if x["kind"] == "batch"]
    iters = [loop_iters(t, [x["route"]["easy_idx"], x["route"]["hard_idx"]])
             for (_, t), x in zip(res, batch_recs)]
    easy_p = router.rung_params(router.easy_rung, daemon.base_params)
    hard_p = router.rung_params(router.hard_rung, daemon.base_params)
    for q, (r, _), rec in zip(batches, res, batch_recs):
        sides.append(len(rec["route"]["hard_idx"]))
        for side, p in (("easy_idx", easy_p), ("hard_idx", hard_p)):
            rows = np.asarray(rec["route"][side], np.int64)
            if rows.size == 0:
                continue
            want, _ = idx.search(q, params=p, telemetry_sink=None, device=dev)
            want = want.ids.cpu().numpy()[rows]  # min(beam_width, k) columns
            require(np.array_equal(r.ids[rows][:, :want.shape[1]], want),
                    f"routed daemon ids differ from search at its {side} rung")
    out["routed"] = {
        "warmup_s": warm_s, **stats(lat, n_req * batch),
        "easy_rung": [router.easy_rung.beam_width, router.easy_rung.max_hops],
        "hard_rung": [router.hard_rung.beam_width, router.hard_rung.max_hops],
        "loop_iters": iters, "hard_frac_path": fracs, "hard_queries": sides,
        "shadow_batches": sum("needed_wide" in x for x in recs),
        "qlog_records": len(recs),
    }
    log("serve routed: " + json.dumps(
        {k: v for k, v in out["routed"].items() if k != "latency_s"}))

    # one request of the adaptive daemon's middle rung under the profiler
    q = batches[0]
    sp = DEFAULT_LADDER[2].params(SearchParams(k=10, kernel="fused"))
    idx.search(q, params=sp, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx.search(q, params=sp, device=dev)
    torch.cuda.synchronize()
    out["profile_1024"] = profile_search(torch, idx, q, dev,
                                         time.perf_counter() - t0, sp)
    log("serve profile (32, 160) x 1024: " + json.dumps(out["profile_1024"]))
    return out


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

    # 3. the kernel API path
    api = api_phase(torch, np, db, eval_q, dev)
    for name, rec in api.items():
        log(f"api {name}: " + json.dumps(rec))
    for name in ("topk_min", "l2dist", "gather_dist"):
        require(api["launches"][name] > 0,
                f"kernel {name} was not launched on the kernel API path")

    # 4. build the index on the card
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

    # 5-6. the search path; counts from here to the end of phase 6
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
    for name in ("gather_rows_dist", "gather_rows_dist_q8", "twotower_score"):
        require(launches[name] > 0,
                f"kernel {name} was not launched on the search path")
    for rows in (l2, cos):
        for v in rows.values():
            require(v["ids"].shape == (len(eval_q), 10)
                    and (v["ids"] >= 0).all(), "search returned invalid ids")

    # 8. the serve path; its own counts (the two daemons' runs)
    serve = serve_phase(torch, np, idx, eval_q, dev)
    serve_launches = serve["launches"]
    log("launches on the serve path: " + json.dumps(serve_launches))
    for name in ("gather_rows_dist", "twotower_score"):
        require(serve_launches[name] > 0,
                f"kernel {name} was not launched on the serve path")

    csrc = "src/repro_torch/csrc/"
    sources = {"gather_rows_dist": csrc + "gather_dist.cu",
               "gather_rows_dist_q8": csrc + "gather_dist.cu",
               "twotower_score": csrc + "twotower_score.cu",
               "topk_min": csrc + "topk.cu", "l2dist": csrc + "l2dist.cu",
               "gather_dist": csrc + "gather_dist.cu"}
    replaces = {"gather_rows_dist": "src/repro/kernels/gather_dist.py:129",
                "gather_rows_dist_q8": "src/repro/kernels/gather_dist.py:205",
                "twotower_score": "src/repro/kernels/twotower_score.py:40",
                "topk_min": "src/repro/kernels/topk.py:40",
                "l2dist": "src/repro/kernels/l2dist.py:49",
                "gather_dist": "src/repro/kernels/gather_dist.py:59"}
    line = []
    for name in sources:
        if name in kres:  # K1-K3: the search and serve paths
            rec = kres[name]
            main_rec = rec.get("l2", rec.get("score"))
            err = max(v["max_abs_err"] for v in rec.values())
            by_path = {"search": launches[name], "serve": serve_launches[name]}
        else:             # K4-K6: the kernel API path
            rec = main_rec = api[name]
            err = rec["max_abs_err"]
            by_path = {"api": api["launches"][name]}
        entry = {
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": err,
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": main_rec.get("library_ms"),
        }
        if name == "twotower_score":
            entry["library_call"] = "torch.nn.functional.cosine_similarity"
        elif name in kres:
            entry["library_note"] = "no single PyTorch call gathers rows and scores them"
            entry["cosine"] = {k: rec["cosine"][k] for k in
                               ("ms", "plain_ms", "bound_ms", "max_abs_err")}
        else:
            entry["library_call"] = rec["library_call"]
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
        "launches": launches, "profile_fused_l2": prof, "api": api,
        "serve": serve,
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
