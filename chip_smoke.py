#!/usr/bin/env python3
"""Drive the repro_torch main path on one CUDA card and check it.

Run from the root of a checkout:
    python3 chip_smoke.py  [--n N] [--queries Q] [--out FILE]
                           [--hop-baseline OTHER/gather_dist.cu]
                           [--kernel-baseline OTHER_CSRC_DIR]

1. Print the card and its power limit; build the CUDA kernels from
   src/repro_torch/csrc with nvcc (all sources in parallel).
2. Kernel phase: every kernel of the search path against its plain PyTorch
   version on the card, at the search path's shapes (K1/K2: 1024 queries x
   32 ids into the N x 128 database, ~10% invalid ids, both metrics; K3 at
   the search's Q queries and a serve request's 1024, x 64 hubs x 128 dims,
   its launch plan held against the wrapper's ``plan``), and timed beside
   its bound.
3. Kernel API path (``repro_torch.kernels.ops``), at the full-mode shapes of
   benchmarks/bench_kernels.py: K5 l2dist 1024 x 8192 x 128, K4 topk_min
   256 x 1024 (k = 32), K6 gather_dist 1024 x 32 x 128 (~10% ids -1), then
   topk_min(l2dist(1024 queries, the first 65,536 db rows), 10) against
   exact_knn, and again on the last 1024 queries and 65,536 rows; K5 and
   K4 also timed alone at that shape (K4's and K5's launch plans held
   against the wrappers' ``plan``).  Driven once with the launch counts at
   0, then each kernel held against its plain version and timed beside its
   bound and the nearest PyTorch call; K4's and K6's times are also given
   net of the timing floor.  With --kernel-baseline, K3, K4, K5 and K6 of
   another source (e.g. the parent commit's) are built beside the port's,
   timed on the same inputs in turns (K3 and K4 at both of their shapes),
   and must give the same bits (K5 in fp32 and from bf16); the fused l2
   search is run again on that K3 and must return the same ids.
4. Build a GATE index over a synthetic SIFT-shaped database (N x 128,
   default N = 1,000,000) with the default GateConfig, on the card.
5. Search Q held-out queries (default 10,000), k = 10: GATE with the
   xla / fused / fused_q8 kernels and the medoid baseline; recall@10 against
   exact ground truth, QPS, and the mean telemetry of one instrumented run.
6. Cosine search with fused and fused_q8 on the same index.
7. One fused and one fused_q8 search under torch.profiler: the device's
   busy and idle share, and the kernels that take it.
   Hop phase: every call of the hop kernel in one fused l2 search of the Q
   queries (K1), one fused_q8 search (K2) and one 1024-query fused search
   at the adaptive daemon's starting rung (K1 at the serve shape) is
   recorded (ids (B, R), R the index's padded degree), replayed under CUDA
   events (sum and median per call) beside its bound from its own ids, and
   every 10th call held against the plain version, l2 and cosine.  With
   --hop-baseline, the hop kernels of another source (e.g. the parent
   commit's) are timed and held on the same calls.
8. Serve phase: a ServeDaemon over the index (kernel "fused", batches of
   1024): 16 requests to an adaptive daemon on DEFAULT_LADDER with /metrics
   scraped once, then 16 to a routed daemon with a query log and shadow
   oversearch; every result is held against an unrouted search at its
   rung; per-request latency, QPS, rungs and the hard_frac path.
9. Feedback phase: the routed daemon's query log read and replayed twice
   (the same output required); a hardness predictor fitted on it on the
   card, saved through the checkpoint manager and loaded back; a routed
   daemon with that predictor_dir hot-reloaded over POST /reload (version
   1, no compile-cache growth, the calibrated hard_frac adopted) serving 16
   requests of 1024 fresh queries, each held against search at its side's
   rung, its latency beside phase 8's formula-routed daemon and the
   learned and formula replay regret recorded; the index saved under
   build/, loaded on the card, and its fused and fused_q8 searches of the
   eval queries required bit-equal to the original's; beam_search_single
   (fused) on 8 queries required equal to the rows of one batched search,
   and K1 at its (1, R) calls timed beside its plain version and bound.
10. Ablation phase, on phase 4's graph: the paper's entry comparison (one
   fused batched_search of the Q eval queries from GATE, medoid, random,
   k-means-tree (branch 8, depth 2) and hash-probe (16 bits) entries;
   recall@10, QPS, mean hops; the GATE and medoid rows must equal phase
   5's); GateConfig(use_hbkm=False) built on the same graph beside the
   default (build seconds, recall@10, QPS); GateConfig(hop_mode="bfs")
   built on a fresh 5,000-row database beside the default build there,
   while hop_counts (host BFS) is timed on 100 targets of the 1M graph in
   a process of its own (read after phase 11) and projected to a 1M bfs
   build; hbkm to 64 leaves in greedy and batch mode (seconds,
   cluster-size variance).  Then greedy_assign held bit-equal to its plain
   version on 20,000 rows (k = 8) and timed there and at the 1M root split
   beside its bound.
11. RAG phase: gemma-2b at its published width (weights drawn on the card,
   seed 0, bf16 compute), a RagPipeline (k = 4, fused) over the index with
   a 128-token block per row: finite logits, two greedy generations equal,
   prefill(S+1) against prefill(S)+decode on a float64 copy (1e-6
   relative) and on a float32 copy (each layer's decode against its
   prefill on the same layer inputs, 1e-3 relative; the logits' difference
   reported), blockwise attention against a naive softmax at one
   request's first-layer shapes (1e-4); then a ServeDaemon(pipeline=) on
   DEFAULT_LADDER serves 8 requests of 32 queries with 64-token prompts
   (576-token contexts, 32 new tokens), each request's retrieved ids held
   against a plain search at its rung; p50 / p99, retrieve / prefill /
   decode seconds from the spans, tokens/s, resident weight bytes; one
   more request under torch.profiler (device busy and idle share, kernels
   launched).
12. MoE RAG phase, after phase 11's model is freed: the router's tie case
   in bf16 on the card (ties to the lowest expert id); internvl2-26b at its
   published width cut to 2 layers in float64 (prefill of 1024 patches +
   S + 1 tokens against the patches + S tokens then one decode, 1e-6);
   then qwen2-moe-a2.7b at its published width and depth (24 layers, 60
   experts top-4 + 4 shared, dense dispatch), weights drawn on the card
   straight into bf16 (at most 34 GB resident), behind the same kind of
   RagPipeline: finite logits, two greedy generations equal; on its first
   two layers at full width, float64 prefill(S+1) against prefill(S) +
   decode (1e-6), the dropping dispatch at capacity E/K against the dense
   one (1e-9) and the share dropped at 1.25, float32 layer by layer
   (1e-3); then 2 requests of 32 queries served as in phase 11, each
   held against a plain search at its rung, and the decode step set
   beside its bounds.
13. Recurrent RAG phase, after phase 12's model is freed: zamba2-1.2b
   (38 Mamba2 layers, the shared attention block after every 6) and then
   rwkv6-1.6b (24 layers), each at its published width and depth, weights
   drawn on the card (seed 0; float32 and a bf16 copy), behind the same
   kind of RagPipeline: finite logits, two greedy generations equal; in
   float64, prefill(S+1) against prefill(S) + decode over two contexts
   (S = 576: the chunked scan's padded tail and the state it hands to the
   step; 1e-6 relative), the same in float32 reported, and layer 0's
   chunked scan on its real inputs against a loop of the single-token
   step (1e-10); then 2 requests of 32 queries served as in phase 11,
   each held against a plain search at its rung, and the decode step set
   beside its byte bound, one step profiled.
14. Training phase, after phase 13's models are freed (no kernel of the
   port is on this path: the enc-dec and training path reaches no Pallas
   kernel in the JAX package).  The drawn init of seamless-m4t-medium
   (wq / wk std 1/sqrt(H)) makes every attention almost one-hot, which
   multiplies rounding with depth and makes the gradients explode, so the
   gated checks below scale every attention's wq / wk to std 1/sqrt(d),
   as the CPU parity tests do, and report the drawn init beside them.
   (a) seamless-m4t-medium at its published width and depth (12 + 12
   layers, 977,758,208 parameters drawn on the card, seed 0, float32 and
   a bf16 copy): two greedy generations of 32 tokens after a 128-token
   prompt and 512 frames a row (4 rows) equal, every logit finite,
   prefill(129) against prefill(128) + decode in float64, scaled (1e-6),
   one decode step profiled beside its byte bound; (b)
   ``repro_torch.launch.train.main`` trains it 12 steps of 8 x 512 with
   2 microbatches at the drawn init and scaled: finite losses and grad
   norms, the scaled run's last loss below its first; median step,
   tokens/s, peak memory, mfu, one more step profiled; (c) in float32 on
   one batch, one sgd step with 1 microbatch against 2 (scaled: loss rtol
   1e-4, parameters rtol 2e-3 / atol 2e-5, gradients 1e-4) and remat on
   against off (every gradient leaf 1e-6); (d) six families' reduced
   configs in float64, one train step's gradients on the card against
   the CPU (1e-10); (e) in a spawned process under the deterministic
   flag, a FaultTolerantRunner over 8 steps of the reduced
   seamless-m4t-medium with failures at steps 3 and 5 ends on the bits of
   an uninterrupted run.
15. Partitioned search phase, after phase 14's models are freed (no
   kernel of the port is on this path: the partitioned search reaches no
   Pallas kernel in the JAX package).  4 ranks in a gloo process group
   share the card as a (2, 2) ("data", "model") mesh; rank p owns rows
   [p·N/4, (p+1)·N/4) of phase 4's database with its own knn_graph(R=16)
   built on the card, and phase 4's tower and hubs;
   ``repro_torch.core.distributed.make_search_step`` (beam 64, 128 hops,
   k = 10) searches the Q eval queries, one warm call and three timed.
   Gates: every rank's merged ids and distances the same and equal to
   this process's composition of the four shards' searches merged by a
   stable top-k (bits); distances ascending, ids unique per row and in
   [0, N); at tests/test_distributed.py's cut (2048 rows, 64 hubs, beam
   32, 64 hops) the card's ids on at least 99% of the CPU's slots and its
   distances within 1e-4 of their largest; cross_pod_grad_sync on a (2,
   2) ("pod", "data") mesh of card tensors 0.5 within 0.02 on every rank;
   a 2-rank data-parallel sgd step of the reduced gemma-2b in float32
   within 1e-6 of the 1-rank loss and rtol 2e-3 / atol 2e-5 of its
   parameters.  Reports recall@10, QPS, the merge's share of a step, each
   rank's peak allocation and graph build seconds.
16. Dry-run phase (no kernel of the port is on this path: the JAX
   package's dry run reaches no Pallas kernel).  (a) In parallel
   subprocesses, ``python -m repro_torch.launch.dryrun`` for gate-anns
   search_1b and search_rag and gemma-2b decode_32k on the 16x16 mesh of
   a fake 256-rank process group (fake tensors on the card's device):
   each exits 0 with ``ok``; its argument bytes a device equal the hand
   count of the rank's shards; a gate cell's collective bytes equal
   mesh_all_gather's per-dimension gathers of its (B, k) ids and
   distances; useful_ratio <= 1; every row fits 80 GiB; the roofline rows
   are printed.  (b) Phase 15's own step priced on a (2, 2) fake mesh at
   phase 15's shapes (250,000 x 128 float32 rows a rank, R 16, 10,000
   queries, beam 64, 128 hops, k 10): phase 15's measured median step
   must not beat 4x the per-rank roofline bound (four ranks share the
   card).  (c) The card's bf16 torch.matmul rate at 8192^3 and a 4 GiB
   device copy's bytes a second, beside the roofline's constants; a
   reading over 105% of a constant fails.  (d) In parallel with (a), the
   sharded train steps of ``TRAIN44_CELLS`` on a (4, 4) fake mesh, 16 x
   128 tokens in 2 microbatches (reduced llama3-8b at vocab 16,384,
   zamba2-1.2b, rwkv6-1.6b; mistral-large-123b at 4 rows, whose rows do
   not divide "data"; seamless-m4t-medium at vocab 16,386, which "model"
   does not divide; qwen2.5-32b at 10 heads over 4; qwen2-moe-a2.7b's
   dropping dispatch at vocab 16,384): each dry-runs, takes
   at most 1.5x repro's compiled temp and collective bytes a device and
   its ``dot_ratio`` (1.1x; zamba2 1.5x) times its dot FLOPs, and no op
   but a weight's shard holds the whole vocabulary; and the decode steps
   of ``DECODE44_CELLS`` (reduced llama3-8b at vocab 16,384, rwkv6-1.6b,
   zamba2-1.2b, seamless-m4t-medium; 16 rows of a 128-slot cache) make no
   op of the whole vocabulary and move at most 1.5x repro's collective
   bytes (rwkv6 and zamba2 1.1x).
17. Examples phase: examples/quickstart_torch.py,
   distributed_search_torch.py (8 gloo ranks sharing the card),
   rag_serve_torch.py and train_lm_torch.py at their defaults (the sizes of
   the repro examples they port), as four subprocesses on the card at
   once: each exits 0, loads no module of the JAX package and prints a
   result that is held: GATE recall@10 at least the medoid's at every
   beam, the merged distributed result the same bits as its
   single-process composition, the RAG batch's k distinct rows and every
   token generated with finite logits, one injected crash survived and
   the loss falling.  Their kernel launches are counted in each
   subprocess and added to the kernels line.
18. OOD phase, after phase 4's index and database are freed: the paper's
   Fig. 6 workload (benchmarks/bench_ood.py) at a real size.  100,000 rows
   of laion3m-like (d = 512, seed 0); GateIndex.build with GateConfig()
   and phase 4's NSG settings, trained on the training half of a 50/50
   in/out log (train_eval_query_split(db, 10,000, 1,000, seed=1,
   ood_fraction=0.5)): build stages, repaired nodes, the padded R and
   memory_bytes; the loss falls and every hub has a positive.  For 5,000
   in-distribution and 5,000 OOD queries (seed 17) against exact ground
   truth: GATE's and the medoid's entries at beams 8-128 (max_hops =
   max(4·beam, 64), fused, l2; recall@10, QPS, mean hops, dist_evals and
   entry_rank_proxy), GATE at least the medoid - 0.02 at every beam; at
   beam 64 xla, fused and fused_q8 (fused ids on 0.999 of xla's, fused_q8
   recall@10 at least fused's - 0.005); GATE's in/out recall gap at beam
   64, reported.  Every K1 / K2 call of a fused and a fused_q8 search of
   the OOD queries recorded and replayed as in the hop phase, every 10th
   held at max abs error 0.0.  Then K1 and K2 at (1024, 247) ids into
   50,000-row databases of text2image10m-like (200), tiny5m-like (384) and
   gist1m-like (960), l2 and cosine: max abs error 0.0, the median time
   beside the bound and the shared-memory ring's rows.

Phases 3, 5-6 and 8-18 are each driven with the kernel launch counts set
to 0 just before and read just after.  Each phase's kernel-launch
requirement:
   phase 3        K4 (topk_min), K5 (l2dist), K6 (gather_dist)
   phases 5-6     K1 (gather_rows_dist), K2 (gather_rows_dist_q8), K3
                  (twotower_score)
   phase 8        K1, K3
   phase 9        K1, K2, K3
   phase 10       K1, K3, greedy_assign
   phases 11-13   K1, K3
   phases 14-15   none (their counts are logged)
   phase 16       none (its counts are logged)
   phase 17       none (counted in each example's process, added to the
                  kernels line)
   phase 18       K1, K2, K3 (the build and the searches)
Every check that fails raises, so the script exits non-zero and prints no
result.  The last line is the JSON result object; the line before it is
the card's name and power limit, and the one before that lists every
kernel (K1 and K2 at the hop phase's 10,000-query calls, K3 at both of
its shapes, K4 and K5 at both of theirs, greedy_assign at its slice and
root split; K1 and K2 also at phase 18's calls and widths).  ``--out FILE`` also writes the full record there as JSON.
Exits non-zero without a CUDA card or outside a checkout.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import importlib
import json
import multiprocessing
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and fp32
# throughput outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# shapes: a serve request's batch (K3), and the kernel API path's
# (benchmarks/bench_kernels.py's full mode, then one exact top-k)
SERVE_BATCH = 1024
L2_SHAPE = (1024, 8192, 128)         # K5: Q, C, d
TOPK_SHAPE = (256, 1024, 32)         # K4: B, C, k
GATHER_SHAPE = (1024, 32, 128)       # K6: B, R, d
COMPOSED_SHAPE = (1024, 65536, 10)   # topk_min(l2dist): queries, db rows, k


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


def cuda_times(torch, fn, reps: int) -> list:
    """Device time of each of ``fn(0)`` … ``fn(reps - 1)``, in ms.

    A sleep kernel keeps the card busy while the host enqueues every call,
    so each CUDA-event pair brackets the device work of one call and not the
    host's launch overhead (tens of microseconds per Python call)."""
    for i in range(min(3, reps)):
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
    return [s.elapsed_time(e) for s, e in events]


def cuda_ms(torch, fn, reps: int = 30) -> float:
    """Median device time of ``fn(i)`` over ``reps`` calls, in ms."""
    return statistics.median(cuda_times(torch, fn, reps))


def hold(torch, np, name, got, want, ids) -> float:
    """A hop kernel's (B, R) output against its plain version's: invalid
    slots exactly 3.4e38, valid ones within rtol = atol = 1e-5.  Returns the
    largest absolute error over the valid slots."""
    torch.cuda.synchronize()
    bad = ids < 0
    require(bool(torch.all(got[bad] == want[bad])) and
            bool(torch.all(got[bad] == np.float32(3.4e38))),
            f"{name}: invalid slots are not exactly 3.4e38")
    ok = torch.isclose(got[~bad], want[~bad], rtol=1e-5, atol=1e-5)
    require(bool(ok.all()), f"{name}: kernel disagrees with its plain version")
    return float((got[~bad] - want[~bad]).abs().max()) if bool((~bad).any()) else 0.0


def hop_kernel_records(torch, np, db, queries, dev, R: int, rng,
                       reps: int = 30) -> dict:
    """K1 and K2 against their plain versions on the card at (B, R) ids
    into ``db`` (B = min(1024, len(queries))), one fresh id set a rep drawn
    from ``rng`` with ~10% of the ids -1, l2 and cosine: the largest error,
    the median time of the kernel and of its plain version, the bound of
    the median rep (``hop_bound`` on its own ids: each distinct valid row
    once), and on the card the shared-memory ring's rows that the kernel
    library sizes (``ring_rows``)."""
    from repro_torch.kernels import gather_rows_dist, gather_rows_dist_q8, ref
    from repro_torch.kernels.gather_dist import ring_rows
    from repro_torch.quant import quantize_db

    N, d = db.shape
    B = min(1024, len(queries))
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

    for name, fn, plain, args_l2, args_cos, row_bytes in (
        ("gather_rows_dist", gather_rows_dist, ref.gather_rows_dist_ref,
         (dbt, q), (dbt, qn, inv), 4 * d),
        ("gather_rows_dist_q8", gather_rows_dist_q8, ref.gather_rows_dist_q8_ref,
         (qdb.codes, qdb.scale, qdb.zero, qp),
         (qdb.codes, qdb.scale, qdb.zero, qnp, qdb.inv_norms), dp + 8 * nb),
    ):
        rec = {}
        ring = (ring_rows(4 * d if name == "gather_rows_dist" else dp)
                if torch.device(dev).type == "cuda" else None)
        for metric, args in (("l2", args_l2), ("cosine", args_cos)):
            err = hold(torch, np, f"{name}/{metric}", fn(ids_all[0], *args),
                       plain(ids_all[0], *args), ids_all[0])
            ms = cuda_ms(torch, lambda i: fn(ids_all[i], *args), reps)
            plain_ms = cuda_ms(torch, lambda i: plain(ids_all[i], *args), reps)
            width = args[-2 if metric == "cosine" else -1].shape[1]
            per_rep = [hop_bound(torch, ids_all[i], row_bytes
                                 + (4 if metric == "cosine" else 0),
                                 4 * width, width) for i in range(reps)]
            b = sorted(per_rep, key=lambda r: r["bound_ms"])[reps // 2]
            rec[metric] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "ring_rows": ring, **b}
        out[name] = rec
    return out


def kernel_phase(torch, np, db, queries, dev, n_hubs: int = 64, n_sm: int = 132,
                 baseline=None) -> dict:
    """Each kernel of the search path against its plain version on the
    card; times and bounds.  K3 at the search's and a serve request's
    shapes, planned for ``n_sm`` SMs; ``baseline`` as ``twotower_record``."""
    from repro_torch.kernels import ref

    N, d = db.shape
    rng = np.random.default_rng(11)
    out = hop_kernel_records(torch, np, db, queries, dev, 32, rng)

    # K3 at the two shapes the main path launches it at: the search's
    # (Q, 64, 128) and a serve request's (1024, 64, 128); query latents and
    # hub reps stand in for the towers' outputs
    TT = importlib.import_module("repro_torch.kernels.twotower_score")
    zq = torch.as_tensor(np.ascontiguousarray(queries[:, :d]), device=dev)
    hubs = torch.as_tensor(db[rng.choice(N, n_hubs, replace=False)], device=dev)
    out["twotower_score"] = {
        path: twotower_record(torch, TT, ref, q_lat, hubs, n_sm, baseline)
        for path, q_lat in (("search", zq), ("serve", zq[:SERVE_BATCH]))}
    return out


def pair_ms(torch, fn, other, reps: int = 30):
    """Median device times of ``fn`` and ``other`` timed in turns (fn,
    other, other, fn), each the mean of its two medians."""
    a1, b1 = cuda_ms(torch, fn, reps), cuda_ms(torch, other, reps)
    b2, a2 = cuda_ms(torch, other, reps), cuda_ms(torch, fn, reps)
    return (a1 + a2) / 2, (b1 + b2) / 2


def hold_baseline(torch, name, got, other) -> float:
    """A kernel's output against the baseline source's on the same inputs:
    the same bits, or the run fails."""
    torch.cuda.synchronize()
    require(got.shape == other.shape and bool(torch.equal(got, other)),
            f"{name}: kernel is not bit-equal to the baseline source's")
    return float((got - other).abs().max()) if got.numel() else 0.0


def time_kernel(torch, rec, name, fn, args_of, got, other=None,
                reps: int = 30) -> dict:
    """``rec["ms"]``: the median device time of ``fn(*args_of(i))``.  With
    ``other`` (the same wrapper on a baseline source, ``baseline_kernel``),
    ``other(*args_of(0))`` must give the bits of ``got`` (a tensor or a
    tuple of them) and the two are timed in turns (``baseline_ms``)."""
    def calls(f):
        return lambda i: f(*args_of(i))

    if other is None:
        rec["ms"] = cuda_ms(torch, calls(fn), reps)
        return rec
    theirs = other(*args_of(0))
    pairs = zip(got, theirs) if isinstance(got, tuple) else [(got, theirs)]
    rec["baseline_max_abs_err"] = max(
        hold_baseline(torch, name, a, b) for a, b in pairs)
    rec["ms"], rec["baseline_ms"] = pair_ms(torch, calls(fn), calls(other), reps)
    return rec


def net_of_floor(rec: dict, floor_ms: float) -> dict:
    """Add ``rec``'s kernel (and baseline) time net of the timing floor,
    an empty kernel's time under the same events, beside the raw one."""
    for key in ("ms", "baseline_ms"):
        if key in rec:
            rec[f"{key}_net"] = rec[key] - floor_ms
    return rec


def twotower_record(torch, TT, ref, zq, hubs, n_sm: int, baseline=None) -> dict:
    """K3 on (B, d) x (H, d): its launch plan (the source's, held against
    ``TT.plan``), its output against the plain version (rtol = atol = 1e-5),
    its time beside its bound, the plain version's and
    ``F.cosine_similarity``'s; with ``baseline`` (libraries from
    ``load_baseline``), the baseline source's time and its bits."""
    B, d = zq.shape
    H = hubs.shape[0]
    want_plan = TT.plan(B, H, d, n_sm=n_sm, aligned=zq.data_ptr() % 16 == 0
                        and hubs.data_ptr() % 16 == 0)
    got_plan = TT.cuda_plan(zq, hubs)
    require(got_plan == want_plan,
            f"twotower_score plan {got_plan} differs from plan() {want_plan}")
    got = TT.twotower_score(zq, hubs)
    want = ref.twotower_score_ref(zq, hubs)
    torch.cuda.synchronize()
    require(bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5)),
            f"twotower_score {B}x{H}x{d}: kernel disagrees with its plain version")
    cos_lib = torch.nn.functional.cosine_similarity
    rec = {
        "shape": [B, H, d], "plan": got_plan,
        "max_abs_err": float((got - want).abs().max()),
        "plain_ms": cuda_ms(torch, lambda i: ref.twotower_score_ref(zq, hubs)),
        "library_ms": cuda_ms(
            torch, lambda i: cos_lib(zq[:, None, :], hubs[None, :, :], dim=-1)),
        **bound((B * d + H * d + B * H) * 4, 2 * B * H * d + 2 * (B + H) * d),
    }
    other = (baseline_kernel(baseline["twotower_score"], TT, "twotower_score")
             if baseline is not None else None)
    return time_kernel(torch, rec, f"twotower_score {B}x{H}x{d}",
                       TT.twotower_score, lambda i: (zq, hubs), got, other)


def l2_record(torch, L2, ref, q, c_of, reps: int, baseline=None) -> dict:
    """K5 on q (Q, d) against candidate sets ``c_of(i)`` (C, d), one per
    timed call: its plan (held against ``L2.plan``), ``c_of(0)``'s output
    against the plain version (rtol 2e-5, atol 2e-4), its time beside its
    bound, the plain version's and ``torch.cdist``'s; with ``baseline``,
    the baseline source's time, and its bits in fp32 and from bf16."""
    c = c_of(0)
    (Q, D), C = q.shape, c.shape[0]
    got_plan = L2.cuda_plan(q, c)
    want_plan = L2.plan(Q, C, D, aligned=q.data_ptr() % 16 == 0
                        and c.data_ptr() % 16 == 0)
    require(got_plan == want_plan,
            f"l2dist plan {got_plan} differs from plan() {want_plan}")
    got = L2.l2dist(q, c)
    want = ref.l2dist_ref(q, c)
    require(bool(torch.allclose(got, want, rtol=2e-5, atol=2e-4)),
            f"l2dist {Q}x{C}x{D}: kernel disagrees with its plain version")
    rec = {
        "shape": [Q, C, D], "plan": got_plan,
        "max_abs_err": float((got - want).abs().max()),
        "plain_ms": cuda_ms(torch, lambda i: ref.l2dist_ref(q, c_of(i)), reps),
        "library_ms": cuda_ms(torch, lambda i: torch.cdist(q, c_of(i)), reps),
        **bound((Q * D + C * D + Q * C) * 4,
                2 * Q * C * D + 2 * (Q + C) * D + 3 * Q * C),
        "library_call": "torch.cdist (returns the root, not its square)",
    }
    del want
    other = None
    if baseline is not None:
        other = baseline_kernel(baseline["l2dist"], L2, "l2dist")
        qb, cb = q.to(torch.bfloat16), c.to(torch.bfloat16)
        rec["bf16_baseline_max_abs_err"] = hold_baseline(
            torch, f"l2dist {Q}x{C}x{D} bf16", L2.l2dist(qb, cb), other(qb, cb))
    return time_kernel(torch, rec, f"l2dist {Q}x{C}x{D}", L2.l2dist,
                       lambda i: (q, c_of(i)), got, other, reps)


def topk_record(torch, TK, ref, d_of, k: int, reps: int, baseline=None,
                got=None) -> dict:
    """K4 on rows ``d_of(i)`` (B, C), one set per timed call: its plan (held
    against ``TK.plan``), ``got`` (or a new launch on ``d_of(0)``) with the
    plain stable sort's indices and values, its time beside its bound, the
    plain version's, ``torch.topk``'s and a plain read's (``read_ms``:
    ``torch.sum`` of the rows, what reading them once costs in practice);
    with ``baseline``, the baseline source's time and its bits."""
    d = d_of(0)
    B, C = d.shape
    got_plan = TK.cuda_plan(d, k)
    want_plan = TK.plan(B, C, k)
    require(got_plan == want_plan,
            f"topk_min plan {got_plan} differs from plan() {want_plan}")
    if got is None:
        got = TK.topk_min(d, k)
    ve, ie = ref.topk_min_ref(d, k)
    require(bool(torch.equal(got[1], ie)) and bool(torch.equal(got[0], ve)),
            f"topk_min {B}x{C} k={k}: kernel disagrees with its plain version")
    rec = {
        "shape": [B, C, k], "plan": got_plan,
        "max_abs_err": float((got[0] - ve).abs().max()),
        "plain_ms": cuda_ms(torch, lambda i: ref.topk_min_ref(d_of(i), k), reps),
        "library_ms": cuda_ms(
            torch, lambda i: torch.topk(d_of(i), k, dim=1, largest=False), reps),
        "read_ms": cuda_ms(torch, lambda i: d_of(i).sum(), reps),
        **bound(B * C * 4 + B * k * 8, B * C * k),
        "library_call": "torch.topk(largest=False), timed only: its tie "
                        "order differs",
    }
    other = (baseline_kernel(baseline["topk"], TK, "topk_min")
             if baseline is not None else None)
    return time_kernel(torch, rec, f"topk_min {B}x{C} k={k}", TK.topk_min,
                       lambda i: (d_of(i), k), got, other, reps)


def api_phase(torch, np, db, queries, dev, reps: int = 30, baseline=None) -> dict:
    """The kernel API path: K5 l2dist, K4 topk_min and K6 gather_dist
    through ``ops`` at bench_kernels.py's full-mode shapes, and one composed
    exact top-10 over the first 65,536 db rows, where K5 and K4 are also
    timed alone.  The path is driven once with the launch counts at 0
    (``launches``); the checks and timings after it are not counted.
    ``baseline`` maps each source's stem to a library from
    ``load_baseline``: K4, K5 and K6 of it are timed in turns with the
    port's and must give the same bits."""
    from repro_torch import exact_knn
    from repro_torch import kernels as K
    from repro_torch.kernels import ops, ref

    L2 = importlib.import_module("repro_torch.kernels.l2dist")
    TK = importlib.import_module("repro_torch.kernels.topk")
    GD = importlib.import_module("repro_torch.kernels.gather_dist")
    rng = np.random.default_rng(12)
    Q, C, D = L2_SHAPE
    B, Ck, k = TOPK_SHAPE
    Bg, Rg, Dg = GATHER_SHAPE
    Qc, Nc, kc = COMPOSED_SHAPE

    def dev_t(a):
        return torch.as_tensor(a, device=dev)

    # a fresh input per timed call, so no call finds the last one's in L2
    lq = dev_t(rng.standard_normal((Q, D), dtype=np.float32))
    lc = dev_t(rng.standard_normal((reps + 3, C, D), dtype=np.float32))
    td = dev_t(rng.standard_normal((reps + 3, B, Ck), dtype=np.float32))
    gv = dev_t(rng.standard_normal((reps + 3, Bg, Rg, Dg), dtype=np.float32))
    gq = dev_t(rng.standard_normal((Bg, Dg), dtype=np.float32))
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

    # K5 l2dist: the counted output has the bits of the one l2_record holds
    require(bool(torch.equal(out_l2, L2.l2dist(lq, lc[0]))),
            "l2dist: two launches on the same inputs differ")
    del out_l2
    out["l2dist"] = l2_record(torch, L2, ref, lq, lambda i: lc[i], reps,
                              baseline)
    # K4 topk_min: values and indices equal to the stable sort
    out["topk_min"] = topk_record(torch, TK, ref, lambda i: td[i], k, reps,
                                  baseline, out_tk)
    # K6 gather_dist: dot form against the plain difference form
    want = ref.gather_dist_ref(gv[0], gq, gi[0])
    bad = gi[0] < 0
    require(bool(torch.all(out_gd[bad] == np.float32(3.4e38))),
            "gather_dist: invalid slots are not exactly 3.4e38")
    require(bool(torch.allclose(out_gd[~bad], want[~bad], rtol=2e-5, atol=2e-4)),
            "gather_dist: kernel disagrees with its plain version")
    n_valid = float((gi[:reps] >= 0).sum()) / reps
    rec = {
        "shape": [Bg, Rg, Dg],
        "max_abs_err": float((out_gd[~bad] - want[~bad]).abs().max()),
        "plain_ms": cuda_ms(
            torch, lambda i: ref.gather_dist_ref(gv[i], gq, gi[i]), reps),
        "library_ms": cuda_ms(
            torch, lambda i: torch.cdist(gv[i], gq[:, None, :]), reps),
        "read_ms": cuda_ms(torch, lambda i: gv[i].sum(), reps),
        **bound(n_valid * Dg * 4 + Bg * Dg * 4 + Bg * Rg * 8, n_valid * Dg * 6),
        "library_call": "torch.cdist of each (R, d) block to its query: the "
                        "nearest single call; it reads every row, masks "
                        "nothing and returns the root",
    }
    other = (baseline_kernel(baseline["gather_dist"], GD, "gather_dist")
             if baseline is not None else None)
    out["gather_dist"] = time_kernel(
        torch, rec, f"gather_dist {Bg}x{Rg}x{Dg}", GD.gather_dist,
        lambda i: (gv[i], gq, gi[i]), out_gd, other, reps)
    # composed: exact top-10 of 1024 queries over 65,536 rows, on the
    # counted set and on a second one (the last 1024 queries and the last
    # 65,536 rows), so the agreement gate has two readings per run
    rec = composed_check(torch, ops, ref, exact_knn, cq, chunk, kc,
                         (comp_v, comp_i))
    comp_d = rec.pop("d")
    rec["ms"] = cuda_ms(
        torch, lambda i: ops.topk_min(ops.l2dist(cq, chunk), kc), 5)
    # K4 alone at this shape (268 MB of distances, five times L2), beside
    # its bound and torch.topk
    rec["topk_min"] = topk_record(torch, TK, ref, lambda i: comp_d, kc, 5,
                                  baseline)
    del comp_d
    # K5 alone at this shape (the same rows every call: 32 MB, in L2)
    rec["l2dist"] = l2_record(torch, L2, ref, cq, lambda i: chunk, 10, baseline)
    second = composed_check(
        torch, ops, ref, exact_knn,
        dev_t(np.ascontiguousarray(queries[len(queries) - Qc:])),
        dev_t(np.ascontiguousarray(db[len(db) - Nc:])), kc)
    del second["d"]
    out["composed_top10"] = {"shape": [Qc, Nc, cq.shape[1], kc], **rec,
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


def timed_search(torch, idx, qd, gt, sp, entry: str, dev) -> dict:
    """One search of ``qd`` from GATE's entries (``entry="gate"``) or the
    medoid's: warmed up once, timed once to ``torch.cuda.synchronize()``,
    then run once instrumented for its telemetry; recall@10 against ``gt``
    where given."""
    from repro_torch import recall_at_k, summarize

    def run(p):
        if entry == "gate":
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
    return {
        "recall_at_10": recall_at_k(ids, gt, 10) if gt is not None else None,
        "qps": len(qd) / secs, "seconds": secs,
        "mean_hops": s["mean_hops"], "mean_dist_evals": s["mean_dist_evals"],
        "mean_bytes_read": s["mean_bytes_read"],
        "mean_nav_hops": s["mean_nav_hops"],
        "mean_entry_rank_proxy": s["mean_entry_rank_proxy"], "ids": ids,
    }


def search_phase(torch, idx, eval_q, gt, metric, kernels, baseline, dev):
    from repro_torch import SearchParams

    qd = torch.as_tensor(eval_q, device=dev)
    rows = {}
    runs = [(f"gate/{k}", k, "gate") for k in kernels]
    if baseline:
        runs.append(("baseline_medoid/fused", "fused", "medoid"))
    for label, kernel, entry in runs:
        sp = SearchParams(k=10, beam_width=64, max_hops=256, metric=metric,
                          kernel=kernel, rerank_mult=4)
        rows[label] = timed_search(torch, idx, qd, gt, sp, entry, dev)
        log(f"search {metric} {label}: " + json.dumps(
            {k: v for k, v in rows[label].items() if k != "ids"}))
    return rows


def profile_call(torch, fn, wall_s: float) -> dict:
    """``fn()`` under ``torch.profiler``: device time (summed over the
    kernels, copies and fills; one stream, so they do not overlap) against
    ``wall_s``, the unprofiled wall time of the same call, the device
    operations launched, and the kernels that take the time.  Only device
    activity is recorded, and it is read from the raw trace events: the
    profiler's own summary (``key_averages``) builds a Python object an
    event, about 70 s for the ~400,000 kernels of one MoE RAG request."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ns, calls = Counter(), Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ns[e.name()] += e.duration_ns()
            calls[e.name()] += 1
    busy_s = sum(ns.values()) * 1e-9
    return {
        "device_busy_s": busy_s if ns else None,
        "wall_s": wall_s,
        "device_idle_share": (1.0 - busy_s / wall_s) if ns else None,
        "kernel_launches": sum(calls.values()),
        # the profiled call and the reading of its trace together
        "profiler_s": time.perf_counter() - t0,
        "top_kernels": [{"name": name[:80], "calls": calls[name],
                         "device_ms": t * 1e-6}
                        for name, t in ns.most_common(8)],
    }


def profile_search(torch, idx, eval_q, dev, wall_s: float, sp=None) -> dict:
    """One search (default: ``fused`` l2, beam 64) under the profiler
    (``profile_call``)."""
    from repro_torch import SearchParams

    qd = torch.as_tensor(eval_q, device=dev)
    if sp is None:
        sp = SearchParams(k=10, beam_width=64, max_hops=256, kernel="fused")
    return profile_call(
        torch, lambda: idx.search(qd, params=sp, telemetry_sink=None,
                                  device=dev), wall_s)


@contextlib.contextmanager
def record_calls(module, name: str):
    """Replace ``module.<name>`` with a wrapper that keeps a clone of each
    call's ids and its other arguments, yield that list of ``(ids, args)``,
    and put the function back after."""
    orig = getattr(module, name)
    calls = []

    def wrapped(ids, *args, **kw):
        calls.append((ids.clone(), args))
        return orig(ids, *args, **kw)

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def hop_bound(torch, ids, row_bytes: int, q_bytes: int, width: int) -> dict:
    """Bound of one hop-kernel call on its own ids (B, R): the ids read and
    the output written (4 bytes a slot each), each distinct valid row once
    (``row_bytes``), the query row (``q_bytes``) of each query that has a
    valid id; 3 operations per element of each valid slot."""
    valid = ids >= 0
    n_valid = int(valid.sum())
    rows = int(torch.unique(ids[valid]).numel())
    active = int(valid.any(dim=1).sum())
    return {**bound(ids.numel() * 8 + rows * row_bytes + active * q_bytes,
                    n_valid * width * 3),
            "valid_slots": n_valid, "distinct_rows": rows,
            "active_queries": active}


def _spread(xs) -> dict:
    return {"mean": statistics.fmean(xs), "median": statistics.median(xs),
            "min": min(xs), "max": max(xs)} if xs else {}


def load_baseline(path: Path):
    """Build another source (e.g. the parent commit's) with the port's nvcc
    flags into the build directory, under a name keyed by its bytes and
    those of the headers it includes, and bind the launch entry points
    (``_LAUNCH``) of the port's wrapper module of the same stem; returns
    ``(lib, ptxas log)``."""
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    key = hashlib.sha256(_build.source_bytes(path)).hexdigest()[:16]
    out = _build.BUILD_DIR / f"baseline-{path.stem}-{key}.so"
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                        str(path)], capture_output=True, text=True)
    require(p.returncode == 0, f"baseline {path} build failed:\n{p.stdout}{p.stderr}")
    functions = importlib.import_module(f"repro_torch.kernels.{path.stem}")._LAUNCH
    return _build.bind(out, functions), p.stdout + p.stderr


def load_baselines(paths) -> dict:
    """``load_baseline`` of each distinct source among ``paths`` (a source
    named twice is built once), one nvcc each, all started together; logs
    each one's ptxas lines and returns ``{resolved path: library}``."""
    unique = list(dict.fromkeys(Path(p).resolve() for p in paths))
    libs = {}
    with ThreadPoolExecutor(max(1, len(unique))) as pool:
        jobs = {p: pool.submit(load_baseline, p) for p in unique}
        for p, job in jobs.items():
            libs[p], blog = job.result()
            log_ptxas(f"baseline {p.stem}", blog)
    return libs


@contextlib.contextmanager
def kernel_library(module, lib):
    """Inside the block, ``module``'s wrappers launch ``lib``'s kernels
    (same checks and arguments) instead of the port's."""
    own, module._lib = module._lib, lambda: lib
    try:
        yield
    finally:
        module._lib = own


def baseline_kernel(lib, module, name: str):
    """The port's wrapper ``module.<name>``, launching ``lib``'s kernel."""
    fn = getattr(module, name)

    def run(*args):
        with kernel_library(module, lib):
            return fn(*args)
    return run


def kernel_name(mangled: str) -> str:
    """The kernel's own name and template arguments from a mangled entry
    name (``..._cu_<8 hex><len><name>I<args>EE...``), else ``mangled``."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if m is None:
        return mangled
    end = m.end() + int(m.group(1))
    args = re.match(r"I(.*?)EE", mangled[end:])
    return mangled[m.end():end] + (f"<{args.group(1)}>" if args else "")


def log_ptxas(tag: str, text: str) -> None:
    """Each kernel's register and spill lines from an ``-Xptxas -v`` log,
    named by the entry function they follow."""
    name = ""
    for ln in text.splitlines():
        entry = re.search(r"entry function '([^']+)'", ln)
        if entry:
            name = kernel_name(entry.group(1))
        elif "registers" in ln or "spill" in ln:
            log(f"  ptxas {tag} {name}: {ln.strip()}")


def hop_phase(torch, np, idx, eval_q, dev, baseline=None, check_every=10,
              n_plain=5, labels=("fused_l2", "fused_q8_l2",
                                 "fused_l2_serve"), tag="hop") -> dict:
    """The hop kernels at the calls the main path really makes.

    Records every call of K1 in one ``fused`` l2 search of the eval queries,
    of K2 in one ``fused_q8`` search, and of K1 in one 1024-query ``fused``
    search at the adaptive daemon's starting rung (the serve shape), by
    wrapping the names ``graphs.search`` looks up at call time.  Then, per
    search: the index width R, the valid slots per call, each call's bound,
    each call replayed once under CUDA events (sum and median), the plain
    version timed on ``n_plain`` calls, and every ``check_every``-th call
    held against the plain version, l2 and cosine.  ``baseline`` is a
    library from ``load_baseline``, timed and held on the same calls.
    ``labels`` picks which of the three searches to record; ``tag`` starts
    each log line."""
    from repro_torch import SearchParams
    from repro_torch.graphs import search as S
    from repro_torch.kernels import gather_rows_dist, gather_rows_dist_q8, ref
    from repro_torch.obs import DEFAULT_LADDER

    def unit(x):
        return x / torch.clamp_min(torch.linalg.norm(x, dim=1, keepdim=True), 1e-9)

    dev_idx = idx._device(dev)
    R = dev_idx["neighbors"].shape[1]
    inv_db = 1.0 / torch.clamp_min(torch.linalg.norm(dev_idx["db"], dim=1), 1e-9)
    base = SearchParams(k=10, beam_width=64, max_hops=256)
    runs = (
        ("fused_l2", "gather_rows_dist", base.replace(kernel="fused"),
         len(eval_q)),
        ("fused_q8_l2", "gather_rows_dist_q8",
         base.replace(kernel="fused_q8", rerank_mult=4), len(eval_q)),
        ("fused_l2_serve", "gather_rows_dist",
         DEFAULT_LADDER[2].params(SearchParams(k=10, kernel="fused")), 1024),
    )
    out = {}
    for label, name, sp, nq in (r for r in runs if r[0] in labels):
        qd = torch.as_tensor(np.ascontiguousarray(eval_q[:nq]), device=dev)
        with record_calls(S, name) as calls:
            idx.search(qd, params=sp, telemetry_sink=None, device=dev)
        torch.cuda.synchronize()
        if name == "gather_rows_dist":
            kern, plain = gather_rows_dist, ref.gather_rows_dist_ref
            db, q, _ = calls[0][1]
            width = db.shape[1]
            row_bytes, q_bytes = 4 * width, 4 * width
            cos_args = (db, unit(q), inv_db)
        else:
            kern, plain = gather_rows_dist_q8, ref.gather_rows_dist_q8_ref
            codes, scale, zero, q, _ = calls[0][1]
            width, nb = codes.shape[1], scale.shape[1]
            row_bytes, q_bytes = width + 8 * nb, 4 * width
            cos_args = (codes, scale, zero, unit(q), dev_idx["quant"].inv_norms)
        hop = [i for i, (ids, _) in enumerate(calls) if ids.shape[1] == R]
        require(len(hop) > 0 and len(hop) >= len(calls) - 1,
                f"{label}: the hop calls are not (B, {R})")
        bounds = [hop_bound(torch, calls[i][0], row_bytes, q_bytes, width)
                  for i in hop]
        versions = [("kernel", kern)]
        if baseline is not None:
            versions.append(("baseline", baseline_kernel(
                baseline, importlib.import_module(
                    "repro_torch.kernels.gather_dist"), name)))
        errs = dict.fromkeys((v for v, _ in versions), 0.0)
        checked = hop[::check_every]
        for i in checked:
            ids, args = calls[i]
            for metric, a in (("l2", args), ("cosine", cos_args)):
                want = plain(ids, *a)
                for v, fn in versions:
                    errs[v] = max(errs[v], hold(
                        torch, np, f"{v} {name} {label}/{metric} call {i}",
                        fn(ids, *a), want, ids))
                del want
        rec = {
            "B": len(qd), "R": R, "width": width, "calls": len(calls),
            "hop_calls": len(hop), "checked_calls": len(checked),
            "valid_slots_per_call": _spread([b["valid_slots"] for b in bounds]),
            "active_queries_per_call": _spread(
                [b["active_queries"] for b in bounds]),
            "distinct_rows_per_call": _spread(
                [b["distinct_rows"] for b in bounds]),
            "bound_ms_median": statistics.median(b["bound_ms"] for b in bounds),
            "bound_ms_sum": sum(b["bound_ms"] for b in bounds),
            "bound_by": statistics.mode(b["bound_by"] for b in bounds),
            "valid_slots": [b["valid_slots"] for b in bounds],
        }
        for v, fn in versions:
            t = cuda_times(torch, lambda j: fn(calls[j][0], *calls[j][1]),
                           len(calls))
            rec[v] = {"ms_median": statistics.median(t[i] for i in hop),
                      "ms_sum": sum(t), "max_abs_err": errs[v],
                      "ms": [t[i] for i in hop]}
        picks = hop[::max(1, len(hop) // n_plain)][:n_plain]
        rec["plain_ms_median"] = cuda_ms(
            torch, lambda j: plain(calls[picks[j % len(picks)]][0],
                                   *calls[picks[j % len(picks)]][1]),
            len(picks))
        out[label] = rec
        log(f"{tag} {label} {name}: " + json.dumps(
            {k: v if not isinstance(v, dict) else
             {kk: vv for kk, vv in v.items() if kk != "ms"}
             for k, v in rec.items() if k != "valid_slots"}))
        del calls
    return out


def search_on_baseline_k3(torch, idx, eval_q, dev, lib) -> dict:
    """The fused l2 search of the eval queries on the port's K3 and on
    ``lib``'s (K3 picks every query's entry hub): the same ids, or the run
    fails."""
    from repro_torch import SearchParams

    TT = importlib.import_module("repro_torch.kernels.twotower_score")
    qd = torch.as_tensor(eval_q, device=dev)
    sp = SearchParams(k=10, beam_width=64, max_hops=256, kernel="fused")
    own = idx.search(qd, params=sp, telemetry_sink=None, device=dev).ids
    with kernel_library(TT, lib):
        other = idx.search(qd, params=sp, telemetry_sink=None, device=dev).ids
    require(bool(torch.equal(own, other)),
            "fused search ids differ on the baseline K3")
    return {"fused_l2_ids_equal": True, "queries": len(qd)}


def agreement(a, b) -> float:
    return float((a == b).mean())


def _batches(np, eval_q, n: int, size: int, offset: int):
    """``n`` request batches of ``size`` eval queries, wrapping around."""
    rows = np.arange(offset * size, (offset + n) * size) % len(eval_q)
    return [np.ascontiguousarray(eval_q[rows[i * size:(i + 1) * size]])
            for i in range(n)]


def check_routed(torch, np, idx, router, base, batches, res, batch_recs, dev):
    """Hold each routed request's ids against ``idx.search`` of its batch
    at the rung of each side of its split (the query log's easy / hard
    rows); returns the hard queries of each request."""
    easy_p = router.rung_params(router.easy_rung, base)
    hard_p = router.rung_params(router.hard_rung, base)
    sides = []
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
    return sides


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
    fracs = []
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
    sides = check_routed(torch, np, idx, router, daemon.base_params, batches,
                         res, batch_recs, dev)
    out["routed"] = {
        "warmup_s": warm_s, **stats(lat, n_req * batch),
        "easy_rung": [router.easy_rung.beam_width, router.easy_rung.max_hops],
        "hard_rung": [router.hard_rung.beam_width, router.hard_rung.max_hops],
        "loop_iters": iters, "hard_frac_path": fracs, "hard_queries": sides,
        "shadow_batches": sum("needed_wide" in x for x in recs),
        "qlog_records": len(recs), "qlog_path": str(qlog),
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


def feedback_phase(torch, np, idx, eval_q, fresh_q, dev, qlog_path,
                   formula: dict, n_req: int = 16, batch: int = 1024,
                   n_single: int = 8, min_labeled: int = 32,
                   work_dir: Path = ROOT / "build") -> dict:
    """The feedback loop and index persistence on the card (phase 9).

    Replays the routed daemon's query log (twice, the same output required),
    fits a hardness predictor on it on ``dev``, versions it through the
    checkpoint manager and loads it back; starts a routed daemon with that
    ``predictor_dir``, hot-reloads it over POST /reload (version 1, no
    compile-cache growth, the calibrated hard_frac adopted) and serves
    ``n_req`` requests of ``fresh_q`` (held per side against ``idx.search``
    at its rung); saves the index under ``work_dir``, loads it on ``dev``
    and requires its ``fused`` and ``fused_q8`` searches of ``eval_q`` to
    be bit-equal to the original's; and holds ``beam_search_single``
    (``fused``) on ``n_single`` queries against the rows of one
    ``batched_search``.  The kernel launches of all of it are the caller's
    to count; K1's (1, R) calls of the single-query searches are returned
    (``single_calls``) for timing after the count.  ``formula`` is phase
    8's routed record, set beside this daemon's latency."""
    from repro_torch import GateIndex, SearchParams
    from repro_torch.feedback import (
        fit_from_records, load_predictor, read_log, replay_compare,
        replay_routing, save_predictor,
    )
    from repro_torch.feedback.fit import dataset_from_records
    from repro_torch.feedback.replay import batch_records
    from repro_torch.graphs import search as S
    from repro_torch.obs import DEFAULT_LADDER
    from repro_torch.serve.daemon import ServeDaemon

    t_phase = time.perf_counter()
    out = {}
    records = read_log(qlog_path)
    X, y = dataset_from_records(records)
    require(X.shape[0] >= min_labeled,
            f"the query log has {X.shape[0]} labeled queries < {min_labeled}")
    r1, r2 = replay_routing(records), replay_routing(records)
    require(r1 == r2, "two replays of the query log differ")
    out["log"] = {"records": len(records), "labeled": int(X.shape[0]),
                  "needed_wide": int(y.sum()),
                  "formula_replay_regret": r1["regret"]}

    # fit on the card, version it, load it back
    work_dir.mkdir(parents=True, exist_ok=True)
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=work_dir))
    pdir = str(scratch / "predictor")
    t0 = time.perf_counter()
    pred = fit_from_records(records, device=dev)
    t_fit = time.perf_counter() - t0
    version = save_predictor(pred, pdir)
    back = load_predictor(pdir)
    require(version == 1 and back.version == 1,
            f"predictor saved as v{version}, loaded as v{back.version}")
    require(all(np.array_equal(back.params[k], pred.params[k])
                for k in pred.params), "the loaded predictor's params differ")
    cmp_ = replay_compare(records, back)
    out["fit"] = {"seconds": t_fit, "metrics": pred.metrics,
                  "calibration": pred.calibration,
                  "learned_regret": cmp_["learned"]["regret"],
                  "formula_regret": cmp_["formula"]["regret"],
                  "learned_mean_hard_frac": cmp_["learned"]["mean_hard_frac"],
                  "formula_mean_hard_frac": cmp_["formula"]["mean_hard_frac"]}
    log("feedback fit: " + json.dumps(out["fit"]))

    # a routed daemon that hot-reloads it, then serves fresh queries
    qlog = scratch / "qlog_learned.jsonl"
    daemon = ServeDaemon(idx, ladder=DEFAULT_LADDER, route=True,
                         kernel="fused", batch_size=batch, metrics_port=0,
                         predictor_dir=pdir, qlog=str(qlog), device=dev)
    t0 = time.perf_counter()
    port = daemon.start()
    warm_s = time.perf_counter() - t0
    batches = [np.ascontiguousarray(fresh_q[i * batch:(i + 1) * batch])
               for i in range(n_req)]
    fracs, lat, res = [], [], []
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/reload",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        router = daemon.router
        require(body.get("status") == "ok", f"POST /reload: {body}")
        info = body["result"]
        want_frac = min(max(pred.calibration["hard_frac"], router.min_frac),
                        router.max_frac)
        require(info["version"] == 1 and router.predictor_version == 1,
                f"reloaded predictor version {info['version']}, "
                f"router {router.predictor_version}")
        require(info["jit_cache_growth"] == 0,
                f"reload grew the compile cache by {info['jit_cache_growth']}")
        require(router.hard_frac == want_frac,
                f"hard_frac {router.hard_frac} != calibrated {want_frac}")
        fracs.append(router.hard_frac)
        for q in batches:
            t0 = time.perf_counter()
            res.append(daemon.search(q, timeout=600))
            lat.append(time.perf_counter() - t0)
            fracs.append(router.hard_frac)
    finally:
        daemon.stop()
    recs = batch_records(read_log(str(qlog)))
    require(len(recs) == n_req, f"learned daemon logged {len(recs)} batches")
    require(all(r["route"]["predictor_version"] == 1 for r in recs),
            "a served batch was not routed by predictor v1")
    sides = check_routed(torch, np, idx, router, daemon.base_params, batches,
                         res, recs, dev)
    n_q = n_req * batch
    out["serve_learned"] = {
        "warmup_s": warm_s, "reload": info,
        "latency_p50_s": float(np.quantile(lat, 0.5)),
        "latency_p99_s": float(np.quantile(lat, 0.99)),
        "qps": n_q / sum(lat), "latency_s": lat,
        "hard_frac_path": fracs, "hard_queries": sides,
        "formula": {k: formula[k] for k in
                    ("latency_p50_s", "latency_p99_s", "qps",
                     "hard_frac_path", "hard_queries")},
    }
    log("feedback serve (learned beside formula): " + json.dumps(
        {k: v for k, v in out["serve_learned"].items() if k != "latency_s"}))

    # index persistence: save, load on the card, the same bits
    path = scratch / "index"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx.save(str(path))
    t_save = time.perf_counter() - t0
    n_bytes = sum(f.stat().st_size for f in path.iterdir())
    t0 = time.perf_counter()
    loaded = GateIndex.load(str(path), device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    qd = torch.as_tensor(eval_q, device=dev)
    for kernel in ("fused", "fused_q8"):
        sp = SearchParams(k=10, beam_width=64, max_hops=256, kernel=kernel,
                          rerank_mult=4)
        a = idx.search(qd, params=sp, telemetry_sink=None, device=dev)
        b = loaded.search(qd, params=sp, telemetry_sink=None, device=dev)
        for f in ("ids", "dists", "hops", "dist_evals"):
            require(bool(torch.equal(getattr(a, f), getattr(b, f))),
                    f"reloaded index: {kernel} {f} differ from the original's")
    del loaded, a, b
    shutil.rmtree(scratch)
    out["persist"] = {"bytes": n_bytes, "save_s": t_save, "load_s": t_load,
                      "queries": len(eval_q),
                      "bit_equal": ["fused", "fused_q8"]}
    log("feedback persist: " + json.dumps(out["persist"]))

    # beam_search_single against the rows of one batched search
    dev_idx = idx._device(dev)
    q8 = torch.as_tensor(np.ascontiguousarray(eval_q[:n_single]), device=dev)
    entries = idx.select_entries(q8, device=dev)
    sp = SearchParams(k=64, beam_width=64, max_hops=256, kernel="fused")
    both = S.batched_search(dev_idx["db"], dev_idx["neighbors"], q8, entries,
                            sp, device=dev)
    with record_calls(S, "gather_rows_dist") as calls:
        for i in range(n_single):
            one = S.beam_search_single(
                dev_idx["db"], dev_idx["neighbors"], q8[i], entries[i],
                beam_width=64, max_hops=256, kernel="fused", device=dev)
            for f, got in zip(("ids", "dists", "hops", "dist_evals"), one):
                require(bool(torch.equal(got, getattr(both, f)[i])),
                        f"beam_search_single {f} differs from batched row {i}")
    out["single"] = {"queries": n_single, "k1_calls": len(calls)}
    out["single_calls"] = calls
    out["seconds"] = time.perf_counter() - t_phase
    return out


def single_query_k1(torch, np, calls, dev, check_every: int = 10) -> dict:
    """K1 at (1, R), the shape ``beam_search_single`` launches: each
    recorded call replayed under CUDA events (median), the plain version
    beside it, every ``check_every``-th call held against it, and the bound
    counted from each call's own ids."""
    from repro_torch.kernels import gather_rows_dist, ref

    R = max(ids.shape[1] for ids, _ in calls)
    hop = [i for i, (ids, _) in enumerate(calls) if ids.shape[1] == R]
    require(len(hop) > 0 and all(calls[i][0].shape[0] == 1 for i in hop),
            "beam_search_single's hop calls are not (1, R)")
    width = calls[0][1][0].shape[1]
    err = 0.0
    for i in hop[::check_every]:
        ids, args = calls[i]
        err = max(err, hold(torch, np, f"K1 (1, {R}) call {i}",
                            gather_rows_dist(ids, *args),
                            ref.gather_rows_dist_ref(ids, *args), ids))
    t = cuda_times(torch, lambda j: gather_rows_dist(calls[hop[j]][0],
                                                     *calls[hop[j]][1]),
                   len(hop))
    tp = cuda_times(torch, lambda j: ref.gather_rows_dist_ref(
        calls[hop[j]][0], *calls[hop[j]][1]), len(hop))
    bounds = [hop_bound(torch, calls[i][0], 4 * width, 4 * width, width)
              for i in hop]
    return {"shape": [1, R], "calls": len(hop), "ms": statistics.median(t),
            "plain_ms": statistics.median(tp),
            "bound_ms": statistics.median(b["bound_ms"] for b in bounds),
            "bound_by": statistics.mode(b["bound_by"] for b in bounds),
            "max_abs_err": err,
            "valid_slots_per_call": _spread([b["valid_slots"] for b in bounds])}


def entry_rules(torch, np, idx, db, dev):
    """The paper's five entry rules over one base graph, as
    benchmarks/common.py::entry_strategies builds them: GATE, the medoid,
    random, the k-means tree (branch 8, depth 2) and the hash probe over
    the hubs (16 bits).  Returns ({name: queries -> (B, 1) ids}, build
    seconds of the tree and the probe)."""
    from repro_torch.core.baselines import (
        build_hash_probe, build_kmeans_tree, hash_entries, kmtree_entries,
    )

    t0 = time.perf_counter()
    tree = build_kmeans_tree(db, branch=8, depth=2, device=dev)
    t_tree = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe = build_hash_probe(db, idx.hubs.ids, n_bits=16)
    t_probe = time.perf_counter() - t0

    def random_entry(q, qd):
        rng = np.random.default_rng(0)
        return rng.integers(0, len(db), (len(q), 1)).astype(np.int32)

    # each rule takes the queries on the host and on the card
    rules = {
        "GATE": lambda q, qd: idx.select_entries(qd, device=dev),
        "medoid": lambda q, qd: np.full((len(q), 1), idx.enter_id, np.int32),
        "random": random_entry,
        "kmtree": lambda q, qd: kmtree_entries(tree, qd, device=dev),
        "hash": lambda q, qd: hash_entries(probe, q),
    }
    return rules, {"kmtree_build_s": t_tree, "hash_build_s": t_probe,
                   "kmtree_leaves": int(len(tree.leaf_entry))}


def entry_search(torch, np, idx, rule, eval_q, gt, sp, dev) -> dict:
    """One ``batched_search`` of ``eval_q`` from ``rule``'s entries, timed
    (entry selection included, after one warm-up) and once instrumented."""
    from repro_torch import batched_search, recall_at_k, summarize

    opnd = idx._device(dev)
    qd = torch.as_tensor(eval_q, device=dev)

    def run(p):
        entries = torch.as_tensor(rule(eval_q, qd), device=dev)
        return batched_search(opnd["db"], opnd["neighbors"], qd, entries, p,
                              device=dev, **idx._search_kwargs(p, dev))

    run(sp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(sp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    _, tele = run(sp.replace(instrument=True))
    ids = res.ids.cpu().numpy()
    return {"recall_at_10": recall_at_k(ids, gt, 10), "qps": len(eval_q) / secs,
            "seconds": secs, "mean_hops": summarize(tele)["mean_hops"],
            "ids": ids}


def gate_row(torch, idx, eval_q, gt, dev) -> dict:
    """recall@10 and QPS of ``idx``'s ``fused`` l2 search, as phase 5
    measures them (``search_phase``)."""
    row = search_phase(torch, idx, eval_q, gt, "l2", ("fused",),
                       baseline=False, dev=dev)["gate/fused"]
    return {k: row[k] for k in ("recall_at_10", "qps", "seconds")}


def build_seconds(report: dict) -> float:
    """The entry layer's build seconds: the stages after the base graph
    that the report has (``repro``'s reports have no ``t_nav``)."""
    return sum(report.get(k, 0.0) for k in ("t_hubs", "t_topo", "t_samples",
                                            "t_train", "t_nav"))


# hop_mode="bfs" is built on a fresh database of BFS_N rows: at 1M,
# hop_counts (a host BFS per unique target) projects to thousands of
# seconds.  The projection times BFS_TIMED targets of the 1M graph in a
# process of its own while phases 10-11 run.
BFS_N = 5_000
BFS_TIMED = 100


def time_hop_counts(neighbors, targets, hub_ids) -> dict:
    """Seconds of ``hop_counts``' reverse CSR, and of its BFS a target, on
    ``targets`` of the graph ``neighbors``."""
    from repro_torch.core.samples import _reverse_csr, hop_counts

    t0 = time.perf_counter()
    _reverse_csr(neighbors)
    t_csr = time.perf_counter() - t0
    t0 = time.perf_counter()
    hop_counts(neighbors, targets, hub_ids)
    t_all = time.perf_counter() - t0
    return {"csr_s": t_csr, "targets_timed": len(targets),
            "s_per_target": max(t_all - t_csr, 0.0) / len(targets)}


def start_bfs_timing(torch, np, pool, idx, train_q, dev, n: int = BFS_TIMED):
    """Start ``time_hop_counts`` on ``pool`` for the first ``n`` unique
    training-query targets of ``idx``'s graph, as the bfs build would take
    them.  Returns (the pending result, the number of unique targets)."""
    from repro_torch.core.samples import top1_targets

    uniq = np.unique(top1_targets(torch.as_tensor(idx.db, device=dev),
                                  train_q, device=dev))
    job = pool.apply_async(time_hop_counts,
                           (idx.neighbors, uniq[:n], idx.hubs.ids))
    return job, len(uniq)


def bfs_projection(timing: dict, unique_targets: int) -> dict:
    """A bfs build's ``hop_counts`` seconds over every unique target, from
    ``time_hop_counts``' reading."""
    return {**timing, "unique_targets": unique_targets,
            "projected_s": timing["csr_s"]
            + unique_targets * timing["s_per_target"]}


def greedy_record(torch, np, db, dev, rows: int = 20_000, k: int = 8) -> dict:
    """``greedy_assign`` on a ``rows`` x ``k`` slice of real distances (the
    first rows of ``db`` to ``k`` of them), held bit-equal to its plain
    version and timed beside it and its bound (the bytes of d2 read once,
    the assignment written once); also timed at the 1M root split's shape."""
    from repro_torch.kernels import greedy_assign, ref

    hb = importlib.import_module("repro_torch.core.hbkm")
    rng = np.random.default_rng(0)
    out = {}
    for label, n in (("slice", rows), ("root_split", len(db))):
        x = torch.as_tensor(db[:n], device=dev)
        c = x[torch.as_tensor(rng.choice(n, k, replace=False), device=dev)]
        d2 = hb._dists_to_centers(x, c).contiguous()
        lam = float(np.float32(float(x.var(0, unbiased=False).mean())
                               / (n / k)))
        target = float(np.float32(n) / np.float32(k))
        got = greedy_assign(d2, lam, target)
        rec = {"shape": [n, k], **bound(n * k * 4 + n * 4, 0),
               "ms": cuda_ms(torch, lambda i: greedy_assign(d2, lam, target),
                             reps=10 if label == "slice" else 3)}
        if label == "slice":
            want = ref.greedy_assign_ref(d2, lam, target)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    "greedy_assign disagrees with its plain version")
            rec["max_abs_err"] = 0.0
            rec["plain_ms"] = cuda_ms(
                torch, lambda i: ref.greedy_assign_ref(d2, lam, target), reps=1)
            rec["library_ms"] = None
        out[label] = rec
    return out


def ablation_phase(torch, np, idx, db, train_q, eval_q, gt, l2_rows, dev,
                   bfs_n: int = BFS_N, n_leaves: int = 64) -> dict:
    """The build's ablation paths and the paper's entry baselines on the
    index's own base graph (phase 10).

    Entry baselines: one ``fused`` ``batched_search`` (phase 5's
    SearchParams) of ``eval_q`` from each of GATE, medoid, random, kmtree
    and hash entries; the GATE and medoid rows must equal phase 5's
    (``l2_rows``).  ``GateConfig(use_hbkm=False)`` from the same graph:
    build seconds, recall@10 and QPS beside the default index's.
    ``hop_mode="bfs"`` on a fresh database of ``bfs_n`` rows (its NSG built
    on the card) beside the default build there (the caller projects the
    full size's BFS).  Each variant is the index's own ``GateConfig`` with
    the one flag changed.  Greedy HBKM to ``n_leaves`` leaves at the
    full size beside the batch mode.  The kernel launches are the caller's
    to count."""
    import dataclasses

    from repro_torch import GateIndex, SearchParams, exact_knn
    from repro_torch.data.synthetic import make_database, train_eval_query_split
    from repro_torch.graphs.nsg import build_nsg

    hb = importlib.import_module("repro_torch.core.hbkm")
    t_phase = time.perf_counter()
    out = {}
    sp = SearchParams(k=10, beam_width=64, max_hops=256, kernel="fused",
                      rerank_mult=4)

    # (a) the paper's entry comparison
    rules, out["entry_build"] = entry_rules(torch, np, idx, db, dev)
    rows = {}
    for name, rule in rules.items():
        rows[name] = entry_search(torch, np, idx, rule, eval_q, gt, sp, dev)
        log(f"entry {name}: " + json.dumps(
            {k: v for k, v in rows[name].items() if k != "ids"}))
    require(np.array_equal(rows["GATE"]["ids"], l2_rows["gate/fused"]["ids"]),
            "GATE-entry batched_search differs from phase 5's GATE search")
    require(np.array_equal(rows["medoid"]["ids"],
                           l2_rows["baseline_medoid/fused"]["ids"]),
            "medoid-entry batched_search differs from phase 5's baseline")
    out["entries"] = {k: {kk: vv for kk, vv in v.items() if kk != "ids"}
                      for k, v in rows.items()}

    # (b) GATE w/o H: plain k-means hubs on the same graph
    t0 = time.perf_counter()
    wo_h = GateIndex.from_graph(
        db, idx.neighbors, idx.enter_id, train_q,
        dataclasses.replace(idx.gcfg, use_hbkm=False), device=dev)
    t_build = time.perf_counter() - t0
    out["without_hbkm"] = {
        "build_s": t_build, "stages_s": build_seconds(wo_h.build_report),
        "t_hubs": wo_h.build_report["t_hubs"],
        **gate_row(torch, wo_h, eval_q, gt, dev),
        "default": {"stages_s": build_seconds(idx.build_report),
                    "t_hubs": idx.build_report["t_hubs"],
                    "recall_at_10": l2_rows["gate/fused"]["recall_at_10"],
                    "qps": l2_rows["gate/fused"]["qps"]},
    }
    log("GATE w/o H: " + json.dumps(out["without_hbkm"]))
    del wo_h

    # (c) hop_mode="bfs" on a fresh database of bfs_n rows
    g_db, _ = make_database("sift10m-like", bfs_n, seed=0)
    g_tq, g_eq = train_eval_query_split(g_db, len(train_q), len(eval_q))
    t0 = time.perf_counter()
    nsg = build_nsg(g_db, R=32, knn_k=32, search_l=64, pool_size=96,
                    device=dev)
    out["bfs"] = {"n": bfs_n, "nsg_s": time.perf_counter() - t0}
    g_nbrs, g_enter = nsg.neighbors, nsg.enter_id
    g_gt, _ = exact_knn(g_eq, g_db, 10, device=dev)
    t0 = time.perf_counter()
    base = GateIndex.from_graph(g_db, g_nbrs, g_enter, g_tq, idx.gcfg,
                                device=dev)
    default_rec = {"build_s": time.perf_counter() - t0,
                   "stages_s": build_seconds(base.build_report),
                   "t_samples": base.build_report["t_samples"],
                   **gate_row(torch, base, g_eq, g_gt, dev)}
    del base
    t0 = time.perf_counter()
    bfs = GateIndex.from_graph(
        g_db, g_nbrs, g_enter, g_tq,
        dataclasses.replace(idx.gcfg, hop_mode="bfs"), device=dev)
    out["bfs"].update({
        "build_s": time.perf_counter() - t0,
        "stages_s": build_seconds(bfs.build_report),
        "t_samples": bfs.build_report["t_samples"],
        "samples": bfs.build_report["samples"],
        **gate_row(torch, bfs, g_eq, g_gt, dev),
        "default": default_rec,
    })
    log("GATE hop_mode=bfs: " + json.dumps(out["bfs"]))
    del bfs

    # (d) greedy HBKM at the full size beside the batch mode
    hubs = {}
    for mode in ("batch", "greedy"):
        t0 = time.perf_counter()
        assign, _ = hb.hbkm(db, n_leaves, mode=mode, device=dev)
        sizes = np.bincount(assign, minlength=n_leaves)
        hubs[mode] = {"seconds": time.perf_counter() - t0,
                      "cluster_size_variance":
                          hb.cluster_size_variance(assign, n_leaves),
                      "sizes_min_max": [int(sizes.min()), int(sizes.max())]}
    out["hbkm"] = hubs
    log(f"hbkm {n_leaves} leaves: " + json.dumps(hubs))
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def attention_check(torch, np, model, params, tokens) -> float:
    """``blockwise_attention`` against a naive full softmax in fp32, on the
    first layer's q, k, v of ``tokens`` (one request); returns the largest
    absolute error over the largest absolute value."""
    from repro_torch.distributed.sharding import NULL_CTX
    from repro_torch.models.common import blockwise_attention, rms_norm

    cfg = model.cfg
    with torch.no_grad():
        x = model._embed_tokens(params, tokens, NULL_CTX)
        B, S, _ = x.shape
        pos = model._positions(x)
        p0 = model._layer(params, 0)
        q, k, v = model._attn_proj_qkv(
            p0, rms_norm(x, p0["attn_norm"], cfg.norm_eps), pos, NULL_CTX)
        got = blockwise_attention(q, k, v, pos, pos, causal=True,
                                  window=cfg.window, chunk=cfg.attn_chunk)
        G = q.shape[2] // k.shape[2]
        kr = k.repeat_interleave(G, dim=2)
        vr = v.repeat_interleave(G, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q * float(1.0 / np.sqrt(q.shape[-1])),
                         kr)
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool,
                                      device=s.device).tril(), float("-inf"))
        want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vr)
    return float((got - want).abs().max() / want.abs().max().clamp_min(1.0))


def chained_decode_rel(torch, model, params, tokens, patches=None,
                       frames=None) -> float:
    """Prefill of all S + 1 ``tokens`` against prefill of the first S then
    one decode, on ``model`` and its compute ``params``: the largest
    difference of the last logits over their largest value.  With
    ``patches`` (a VLM's) both prefills put them in front of the tokens;
    with ``frames`` (the enc-dec's) both encode them.  Raises if either is
    not finite."""
    extra = {} if patches is None else {"patches": patches}
    if frames is not None:
        extra["frames"] = frames
    P = 0 if patches is None else patches.shape[1]
    S = tokens.shape[1] - 1
    t = torch.full((tokens.shape[0],), P + S, dtype=torch.int32,
                   device=tokens.device)
    with torch.no_grad():
        full, _ = model.prefill(params, {"tokens": tokens, **extra})
        _, cache = model.prefill(params, {"tokens": tokens[:, :S], **extra},
                                 capacity=P + S + 1)
        step, _ = model.decode(params, tokens[:, S:], cache, t)
    require(bool(torch.isfinite(full).all() and torch.isfinite(step).all()),
            f"{model.cfg.name}: {model.cfg.compute_dtype} logits are not "
            "finite")
    return float((step - full).abs().max() / full.abs().max())


def layerwise_decode_check(torch, model, params, tokens) -> float:
    """Prefill against decode layer by layer: for each layer, given the
    layer inputs of a prefill of all S + 1 tokens, the layer's decode of
    position S on the cache of its first S inputs against its full
    forward at position S.  Returns the largest difference of the layer's
    output increment (its attention + MLP update) over that increment's
    largest value, across layers and rows."""
    from repro_torch.distributed.sharding import NULL_CTX

    with torch.no_grad():
        x = model._embed_tokens(params, tokens, NULL_CTX)
        B, S1, _ = x.shape
        S = S1 - 1
        pos = model._positions(x)
        t = torch.full((B,), S, dtype=torch.int32, device=x.device)
        worst = 0.0
        for i in range(model.cfg.num_layers):
            p_l = model._layer(params, i)
            y, _, _ = model._layer_full(p_l, x, pos, NULL_CTX)
            _, (k, v), _ = model._layer_full(p_l, x[:, :S], pos[:, :S],
                                             NULL_CTX)
            cache = model._cache_from_prefill(k[None], v[None], pos[:, :S], S,
                                              capacity=S1)
            y_dec, _, _, _ = model._layer_decode(
                p_l, x[:, S:], cache["k"][0], cache["v"][0], cache["pos"], t,
                NULL_CTX)
            want = (y[:, S] - x[:, S]).to(torch.float32)
            got = (y_dec[:, 0] - x[:, S]).to(torch.float32)
            worst = max(worst, float((got - want).abs().max()
                                     / want.abs().max().clamp_min(1e-30)))
            x = y
    return worst


def router_tie_case(np, E: int, K: int, d: int, tokens: int, seed: int = 0):
    """Router inputs whose logits tie exactly at the K-th / (K+1)-th place
    for every token.  ``w``'s column j is a shared random column plus
    ``c_j`` on input 0, and every token's input 0 is at least 4: experts
    0 … K−2 get c = K … 2 (the top K−1, in that order), experts K−1 and
    E−1 share c = 1 (identical columns, so their logits are equal in any
    dtype), the rest −1.  Ties to the lowest id pick experts 0 … K−1 in
    order; any other tie order picks E−1, another set.  Returns (x (1,
    tokens, d), w (d, E), the ids wanted (K,)), float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, tokens, d)).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 4.0
    c = np.full(E, -1.0, np.float32)
    c[:K - 1] = np.arange(K, 1, -1)
    c[[K - 1, E - 1]] = 1.0
    w = np.repeat(rng.standard_normal((d, 1)).astype(np.float32) * 0.05, E,
                  axis=1)
    w[0] += c
    return x, w, np.arange(K)


def rag_pipeline(np, idx, eval_q, engine, dev, n_req: int, batch: int,
                 prompt_len: int, doc_len: int, new: int, out: dict):
    """A ``RagPipeline`` (k = 4, ``fused``) over ``idx`` feeding
    ``engine``, every row of the index given a ``doc_len``-token block
    (``default_rng(0)``, which then draws the ``n_req`` prompts); the
    first request's context generated twice: its logits must be finite and
    the two greedy generations equal.  Returns (pipeline, query batches,
    prompts, that context, the first generation); records the context
    length and the block-drawing seconds in ``out``."""
    from repro_torch.serve.retrieval import RagPipeline

    cfg = engine.cfg
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    doc_tokens = rng.integers(2, cfg.vocab_size, (len(idx.db), doc_len),
                              dtype=np.int32)
    out["doc_tokens_s"] = time.perf_counter() - t0
    pipe = RagPipeline(idx, engine, doc_tokens, k=4, kernel="fused", device=dev)
    batches = _batches(np, eval_q, n_req, batch, 0)
    prompts = [rng.integers(2, cfg.vocab_size, (batch, prompt_len),
                            dtype=np.int32) for _ in range(n_req)]
    ids0 = pipe(batches[0], prompts[0], max_new_tokens=1).retrieved_ids
    ctx = pipe._splice(prompts[0], ids0)
    out["context_len"] = int(ctx.shape[1])
    g1 = engine.generate({"tokens": ctx}, new)
    g2 = engine.generate({"tokens": ctx}, new)
    require(bool(np.isfinite(g1.logits_last).all()),
            f"{cfg.name}: logits are not finite")
    require(np.array_equal(g1.tokens, g2.tokens),
            f"{cfg.name}: two greedy generations of one batch differ")
    return pipe, batches, prompts, ctx, g1


def rag_phase(torch, np, idx, eval_q, dev, n_req: int = 16, batch: int = 32,
              prompt_len: int = 64, doc_len: int = 128, new: int = 32,
              cfg=None) -> dict:
    """RAG serving with a dense decoder at its published width (phase 11).

    The model's weights are drawn on the card (``torch.Generator``, seed
    0); every row of the index gets a ``doc_len``-token block
    (``default_rng(0)``).  Checks, each raising: finite logits; two
    generations of one batch give the same tokens; prefill of S + 1 tokens
    against prefill of S then one decode, S + 1 one request's context: on
    a float64 copy the logits within 1e-6 relative, on a float32 copy each
    layer's decode against its prefill given the same layer inputs (1e-3)
    and the logits' difference reported; ``blockwise_attention`` against a
    naive softmax at one request's first-layer shapes (1e-4).  Then a ``ServeDaemon`` with a
    ``RagPipeline`` (k = 4, ``fused``) on ``DEFAULT_LADDER`` serves
    ``n_req`` requests of ``batch`` queries with prompts, and one more
    request runs under the profiler; the kernel launches are the caller's
    to count, and the per-request checks against ``idx.search`` at each
    request's rung run after (``check``).  ``cfg`` defaults to gemma-2b's published config."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import count_params
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine

    t_phase = time.perf_counter()
    cfg = get_config("gemma-2b") if cfg is None else cfg
    arch = cfg.name
    model = build_model(cfg)
    out = {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "params": count_params(model.param_table())}
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(cfg, params, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["resident_bytes"] = engine.resident_bytes()
    pipe, batches, prompts, ctx, g1 = rag_pipeline(
        np, idx, eval_q, engine, dev, n_req, batch, prompt_len, doc_len, new,
        out)
    c2 = torch.as_tensor(ctx[:2], device=dev)
    # end to end in float32, the random-init model amplifies rounding (repro
    # does the same: tests/test_torch_lm_precision.py), so that difference
    # is reported; in float64 the same comparison is held, and in float32
    # each layer's decode against its prefill
    e32 = ServeEngine(cfg.with_(compute_dtype="float32"), engine.params,
                      device=dev)
    rel = chained_decode_rel(torch, e32.model, e32.compute_params, c2)
    layer_rel = layerwise_decode_check(torch, e32.model, e32.compute_params, c2)
    require(layer_rel <= 1e-3,
            f"{arch}: a layer's decode differs from its prefill by "
            f"{layer_rel:.3g} relative > 1e-3")
    att = attention_check(torch, np, e32.model, e32.compute_params, c2[:1])
    require(att <= 1e-4, f"{arch}: blockwise_attention off a naive softmax by "
                         f"{att:.3g} > 1e-4")
    del e32
    e64 = ServeEngine(cfg.with_(compute_dtype="float64"), engine.params,
                      device=dev)
    rel64 = chained_decode_rel(torch, e64.model, e64.compute_params, c2)
    require(rel64 <= 1e-6,
            f"{arch}: float64 prefill(S+1) and prefill(S)+decode differ by "
            f"{rel64:.3g} relative > 1e-6")
    del e64
    torch.cuda.empty_cache()
    out["checks"] = {"finite": True, "greedy_repeatable": True,
                     "prefill_decode_rel_err": rel,
                     "prefill_decode_rel_err_f64": rel64,
                     "layer_decode_rel_err": layer_rel,
                     "attention_rel_err": att,
                     "tokens_first_row": g1.tokens[0, :8].tolist()}
    log(f"rag model checks ({arch}): " + json.dumps(out["checks"]))
    out.update(rag_serve(torch, np, idx, pipe, batches, prompts, new, dev))
    out["seconds"] = time.perf_counter() - t_phase
    return out


def rag_serve(torch, np, idx, pipe, batches, prompts, new: int, dev,
              tag: str = "rag") -> dict:
    """``pipe`` behind a ``ServeDaemon`` on ``DEFAULT_LADDER`` serving one
    request of each batch of queries and prompts in turn, traced; then one
    more request of the first batch, timed, and again under the profiler.
    Returns {"serve", "profile_request", "check"} (``check`` for
    ``check_rag``)."""
    from repro_torch.obs import DEFAULT_LADDER, get_tracer
    from repro_torch.serve.daemon import SearchRequest, ServeDaemon

    arch = pipe.engine.cfg.name
    batch = len(batches[0])
    out = {}
    daemon = ServeDaemon(idx, pipeline=pipe, ladder=DEFAULT_LADDER,
                         kernel="fused", batch_size=batch, device=dev)
    tracer = get_tracer()
    t0 = time.perf_counter()
    daemon.start()
    warm_s = time.perf_counter() - t0
    lat, rungs, res = [], [], []
    tracer.start()
    try:
        for q, pr in zip(batches, prompts):
            rungs.append(daemon.controller.params)
            t0 = time.perf_counter()
            res.append(daemon.submit(SearchRequest(
                queries=q, k=4, prompt_tokens=pr, max_new_tokens=new,
            )).get(timeout=600))
            lat.append(time.perf_counter() - t0)
    finally:
        tracer.stop()
        daemon.stop()
    spans = tracer.span_summary()
    tokens = sum(r.generation.tokens.size for r in res)
    for r in res:
        require(bool(np.isfinite(r.generation.logits_last).all()),
                f"{arch}: served logits are not finite")
        require(r.generation.tokens.shape == (batch, new),
                "served generation has the wrong shape")
    sec = {name: spans.get(key, {}).get("total_s", 0.0) for name, key in (
        ("retrieve", "rag.retrieve"), ("prefill", "serve.prefill"),
        ("decode", "serve.decode"))}
    out["serve"] = {
        "warmup_s": warm_s, "latency_p50_s": float(np.quantile(lat, 0.5)),
        "latency_p99_s": float(np.quantile(lat, 0.99)), "latency_s": lat,
        "span_seconds": sec, "tokens": tokens,
        "tokens_per_s": tokens / sum(lat),
        "decode_tokens_per_s": tokens / sec["decode"] if sec["decode"] else None,
        "rungs": [[r.beam_width, r.max_hops] for r in rungs],
    }
    log(f"{tag} serve: " + json.dumps(
        {k: v for k, v in out["serve"].items() if k != "latency_s"}))

    # one more request of the first batch, timed, then again under the
    # profiler (the daemon's requests warmed everything)
    def one():
        pipe(batches[0], prompts[0], max_new_tokens=new)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    out["profile_request"] = profile_call(torch, one, time.perf_counter() - t0)
    log(f"{tag} profile, one request: " + json.dumps(out["profile_request"]))
    out["check"] = (batches, rungs, res, pipe.base_params)
    return out


def check_rag(torch, np, idx, check, dev) -> int:
    """Each served request's retrieved ids against ``idx.search`` of its
    batch at the rung it was served at; returns the requests checked."""
    batches, rungs, res, base = check
    for q, rung, r in zip(batches, rungs, res):
        want = idx.search(q, params=rung.params(base.replace(instrument=True)),
                          telemetry_sink=None, device=dev)[0]
        require(np.array_equal(r.retrieved_ids, want.ids.cpu().numpy()),
                f"RAG request ids differ from search at rung {rung}")
    return len(res)

def layer_cut(torch, model, params, n: int, dtype: str):
    """The first ``n`` layers of ``model`` at full width, sliced from its
    layer-stacked ``params`` and cast to ``dtype`` (norms as they are).
    Returns (model, params)."""
    from repro_torch.models.model import build_model

    cut = build_model(model.cfg.with_(num_layers=n, compute_dtype=dtype))
    layered = set(model._layer_names())
    with torch.no_grad():
        sliced = {k: (v[:n] if k in layered else v) for k, v in params.items()}
        return cut, cut.compute_params(sliced)


def last_logits(torch, model, params, tokens):
    with torch.no_grad():
        return model.prefill(params, {"tokens": tokens})[0]


def moe_cut_checks(torch, np, model, params, tokens) -> dict:
    """Checks (c) and (d) of phase 12 on the first two layers of ``model``
    at full width: in float64, prefill(S+1) against prefill(S) + decode
    (1e-6 relative) and the dropping dispatch at capacity factor E/K,
    where nothing is dropped, against the dense one (1e-9 on the last
    logits); in float32 each layer's decode against its prefill (1e-3),
    the end-to-end difference reported; at the config's capacity factor
    the share of token slots the dropping dispatch drops."""
    from dataclasses import replace

    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model import build_model

    arch, moe = model.cfg.name, model.cfg.moe
    out = {}
    m32, p32 = layer_cut(torch, model, params, 2, "float32")
    out["layer_decode_rel_err_f32"] = layerwise_decode_check(torch, m32, p32,
                                                             tokens)
    out["prefill_decode_rel_err_f32"] = chained_decode_rel(torch, m32, p32,
                                                           tokens)
    require(out["layer_decode_rel_err_f32"] <= 1e-3,
            f"{arch}: a layer's float32 decode differs from its prefill by "
            f"{out['layer_decode_rel_err_f32']:.3g} relative > 1e-3")
    del m32, p32
    m64, p64 = layer_cut(torch, model, params, 2, "float64")
    out["prefill_decode_rel_err_f64"] = chained_decode_rel(torch, m64, p64,
                                                           tokens)
    require(out["prefill_decode_rel_err_f64"] <= 1e-6,
            f"{arch}: float64 prefill(S+1) and prefill(S)+decode differ by "
            f"{out['prefill_decode_rel_err_f64']:.3g} relative > 1e-6")
    dense = last_logits(torch, m64, p64, tokens)
    full_cf = moe.num_experts / moe.experts_per_token
    orig = moe_lib._scatter_group
    for cf in (full_cf, moe.capacity_factor):
        dropping = build_model(m64.cfg.with_(moe=replace(
            moe, impl="dropping", capacity_factor=cf)))
        keeps = []

        def recording(*a, **kw):
            res = orig(*a, **kw)
            keeps.append(res[1])
            return res

        moe_lib._scatter_group = recording
        try:
            logits = last_logits(torch, dropping, p64, tokens)
        finally:
            moe_lib._scatter_group = orig
        kept = sum(int(k.sum()) for k in keeps)
        slots = sum(k.numel() for k in keeps)
        out[f"dropped_share_cf_{cf:g}"] = 1.0 - kept / slots
        if cf == full_cf:
            out["dropping_vs_dense_rel_err_f64"] = float(
                (logits - dense).abs().max() / dense.abs().max())
            require(kept == slots, f"{arch}: capacity E/K dropped a slot")
            require(out["dropping_vs_dense_rel_err_f64"] <= 1e-9,
                    f"{arch}: dropping at capacity E/K differs from dense by "
                    f"{out['dropping_vs_dense_rel_err_f64']:.3g} > 1e-9")
    del m64, p64, dense, logits
    torch.cuda.empty_cache()
    return out


def vlm_prefix_check(torch, np, cfg, dev, S: int = 64, B: int = 2) -> dict:
    """Check (e) of phase 12: ``cfg`` (a VLM) at its published width, cut
    to 2 layers and drawn on the card in float64 (seed 0): prefill of the
    patches plus S + 1 tokens against prefill of the patches plus S tokens
    then one decode, within 1e-6 relative; the logits finite."""
    from repro_torch.models.model import build_model

    t0 = time.perf_counter()
    cut = cfg.with_(num_layers=2, compute_dtype="float64")
    model = build_model(cut)
    params = model.init_compute(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(2, cfg.vocab_size, (B, S + 1),
                                          dtype=np.int32), device=dev)
    patches = torch.as_tensor(rng.standard_normal(
        (B, cfg.num_patches, cfg.patch_dim)).astype(np.float32), device=dev)
    rel = chained_decode_rel(torch, model, params, tokens, patches)
    require(rel <= 1e-6, f"{cfg.name}: float64 prefill of the patches + S+1 "
                         f"tokens and prefill(S)+decode differ by {rel:.3g} "
                         "> 1e-6")
    out = {"arch": cfg.name, "layers": 2, "d_model": cfg.d_model,
           "patches": [cfg.num_patches, cfg.patch_dim], "tokens": S + 1,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.values()),
           "prefill_decode_rel_err_f64": rel,
           "seconds": time.perf_counter() - t0}
    del params
    torch.cuda.empty_cache()
    return out


def moe_rag_phase(torch, np, idx, eval_q, dev, n_req: int = 8,
                  batch: int = 32, prompt_len: int = 64, doc_len: int = 128,
                  new: int = 32, cfg=None, vlm_cfg=None,
                  max_weight_bytes: float = 34e9) -> dict:
    """RAG serving with the MoE decoder at full width and depth (phase 12).

    (f) the router tie case (``router_tie_case``) at the model's expert
    count and width, in bf16 on the card: ids lowest first; (e) the VLM
    prefix (``vlm_prefix_check``, ``vlm_cfg`` default internvl2-26b).
    Then the model, drawn on the card straight into its compute dtype
    (``init_compute``, seed 0; at most ``max_weight_bytes`` resident)
    behind a ``RagPipeline`` (``rag_pipeline``: (a) finite logits, (b) two
    greedy generations equal); (c) and (d) on a 2-layer cut
    (``moe_cut_checks``); then ``rag_serve``.  The decode step is set
    beside two bounds: every weight byte read once (the dense dispatch
    reads every expert) and only the active ones (top-k of the experts,
    what a dropping dispatch could read).  ``cfg`` defaults to
    qwen2-moe-a2.7b's published config."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.common import count_params
    from repro_torch.models.model import active_param_count, build_model
    from repro_torch.serve.engine import ServeEngine

    t_phase = time.perf_counter()
    cfg = get_config("qwen2-moe-a2.7b") if cfg is None else cfg
    vlm_cfg = get_config("internvl2-26b") if vlm_cfg is None else vlm_cfg
    arch, moe = cfg.name, cfg.moe
    model = build_model(cfg)
    out = {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "experts": [moe.num_experts, moe.experts_per_token,
                       moe.shared_experts], "impl": moe.impl,
           "params": count_params(model.param_table()),
           "active_params": active_param_count(cfg)}

    # (f) ties to the lowest expert id, in bf16 on the card
    x, w, want = router_tie_case(np, moe.num_experts, moe.experts_per_token,
                                 cfg.d_model, batch)
    with torch.no_grad():
        _, ids, _ = moe_lib._router(
            torch.as_tensor(x, device=dev).to(torch.bfloat16),
            torch.as_tensor(w, device=dev).to(torch.bfloat16), moe)
    require(bool((ids.cpu() == torch.as_tensor(want)).all()),
            f"{arch}: router ties do not go to the lowest expert id")
    out["router_ties_lowest_first"] = True
    # (e) the VLM patch prefix at its published width
    out["vlm"] = vlm_prefix_check(torch, np, vlm_cfg, dev)
    log("vlm prefix check: " + json.dumps(out["vlm"]))

    t0 = time.perf_counter()
    params = model.init_compute(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(cfg, params, device=dev)
    del params
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["resident_bytes"] = engine.resident_bytes()
    out["max_memory_allocated_after_init"] = torch.cuda.max_memory_allocated()
    require(out["resident_bytes"]["total"] <= max_weight_bytes,
            f"{arch}: {out['resident_bytes']['total']} weight bytes resident "
            f"> {max_weight_bytes:.3g}")
    pipe, batches, prompts, ctx, g1 = rag_pipeline(
        np, idx, eval_q, engine, dev, n_req, batch, prompt_len, doc_len, new,
        out)
    out["checks"] = {"finite": True, "greedy_repeatable": True,
                     "router_ties_lowest_first": True,
                     "tokens_first_row": g1.tokens[0, :8].tolist(),
                     **moe_cut_checks(torch, np, model, engine.params,
                                      torch.as_tensor(ctx[:2], device=dev))}
    log(f"moe model checks ({arch}): " + json.dumps(out["checks"]))
    out.update(rag_serve(torch, np, idx, pipe, batches, prompts, new, dev,
                         tag="moe rag"))
    # the decode step against its bounds
    steps = n_req * new
    dec_s = out["serve"]["span_seconds"]["decode"]
    all_bytes = out["resident_bytes"]["total"]
    active = sum(p.numel() * p.element_size() * (
        moe.experts_per_token / moe.num_experts
        if n in ("we_gate", "we_up", "we_down") else 1)
        for n, p in engine.params.items())
    out["decode_step"] = {
        "ms": dec_s / steps * 1e3 if steps else None,
        "prefill_s_per_request": out["serve"]["span_seconds"]["prefill"] / n_req,
        "bound_ms_dense_all_bytes": all_bytes / PEAK_BYTES_PER_S * 1e3,
        "bound_ms_active_bytes": active / PEAK_BYTES_PER_S * 1e3,
        "all_bytes": all_bytes, "active_bytes": active}
    log("moe decode step against its bounds: " + json.dumps(out["decode_step"]))
    del pipe, engine
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def rel_err(torch, got, want) -> float:
    """The largest difference over the largest value of ``want``."""
    return float((got - want).abs().max() / want.abs().max())


def scan_check(torch, model, params, tokens) -> dict:
    """Check (d) of phase 13: layer 0's chunked scan on its real inputs
    (``tokens`` through the embedding and the layer's input side, in the
    dtype of ``params``) against a loop of the single-token step over the
    same tokens from a zero state.  Returns the relative errors of the
    outputs and of the final state."""
    from repro_torch.models import rwkv as rwkv_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.common import rms_norm

    cfg = model.cfg
    with torch.no_grad():
        x = model._embed(params, tokens)
        p0 = model._layer(params, 0)
        if cfg.family == "hybrid":
            _, xh, dt, A, Bm, Cm = ssm_lib.mamba_scan_inputs(p0, x, cfg)
            y, state = ssm_lib.ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
            st, ys = torch.zeros_like(state), []
            for s in range(xh.shape[1]):
                y_s, st = ssm_lib.ssd_decode_step(xh[:, s], dt[:, s], A,
                                                  Bm[:, s], Cm[:, s], st)
                ys.append(y_s)
            chunk = cfg.ssm_chunk
        else:
            h = rms_norm(x, p0["ln1"], cfg.norm_eps)
            r, k, v, logw, _ = model.wkv_inputs(p0, h, rwkv_lib._shift(h))
            y, state = rwkv_lib.wkv6_chunked(r, k, v, logw, p0["u"],
                                             cfg.rwkv_chunk)
            st, ys = torch.zeros_like(state), []
            for s in range(r.shape[1]):
                y_s, st = rwkv_lib.wkv6_step(r[:, s], k[:, s], v[:, s],
                                             logw[:, s], p0["u"], st)
                ys.append(y_s)
            chunk = cfg.rwkv_chunk
    return {"shape": list(tokens.shape), "chunk": chunk,
            "chunks": -(-tokens.shape[1] // chunk),
            "output_rel_err": rel_err(torch, y, torch.stack(ys, 1)),
            "state_rel_err": rel_err(torch, state, st)}


def recurrent_rag(torch, np, idx, eval_q, dev, cfg, n_req: int, batch: int,
                  prompt_len: int, doc_len: int, new: int) -> dict:
    """One recurrent model of phase 13 (``cfg`` at its published width
    and depth): weights drawn on the card (seed 0, float32, with their
    bf16 copy) behind a ``RagPipeline`` (``rag_pipeline``: (a) finite
    logits, two greedy generations equal); (b) in float64, prefill of
    S + 1 tokens (one request's context and its first generated token)
    against prefill(S) + one decode over two rows, 1e-6 relative; (c) the
    same in float32, reported; (d) ``scan_check`` in float64 at those
    tokens, 1e-10; (e)-(f) ``rag_serve``; (g) the decode step against its
    byte bound (the bf16 weights but the embedding, the recurrent state
    read and written, the KV cache read) and the kernels of one decode
    step under the profiler."""
    from repro_torch.models.common import count_params
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine

    t_phase = time.perf_counter()
    arch = cfg.name
    model = build_model(cfg)
    out = {"arch": arch, "family": cfg.family, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "params": count_params(model.param_table())}
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(cfg, params, device=dev)
    del params
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["resident_bytes"] = engine.resident_bytes()
    pipe, batches, prompts, ctx, g1 = rag_pipeline(
        np, idx, eval_q, engine, dev, n_req, batch, prompt_len, doc_len, new,
        out)
    toks = torch.as_tensor(np.concatenate([ctx[:2], g1.tokens[:2, :1]], 1),
                           device=dev)  # (2, S + 1)
    checks = {"finite": True, "greedy_repeatable": True,
              "tokens_first_row": g1.tokens[0, :8].tolist()}
    for dt in ("float32", "float64"):
        e = ServeEngine(cfg.with_(compute_dtype=dt), engine.params, device=dev)
        checks[f"prefill_decode_rel_err_{dt[-2:]}"] = chained_decode_rel(
            torch, e.model, e.compute_params, toks)
        if dt == "float64":
            checks["scan"] = scan_check(torch, e.model, e.compute_params, toks)
        del e
        torch.cuda.empty_cache()
    require(checks["prefill_decode_rel_err_64"] <= 1e-6,
            f"{arch}: float64 prefill(S+1) and prefill(S)+decode differ by "
            f"{checks['prefill_decode_rel_err_64']:.3g} relative > 1e-6")
    sc = checks["scan"]
    require(max(sc["output_rel_err"], sc["state_rel_err"]) <= 1e-10,
            f"{arch}: float64 chunked scan off its step loop by "
            f"{sc['output_rel_err']:.3g} / {sc['state_rel_err']:.3g} > 1e-10")
    out["checks"] = checks
    log(f"recurrent model checks ({arch}): " + json.dumps(checks))
    out.update(rag_serve(torch, np, idx, pipe, batches, prompts, new, dev,
                         tag=f"{arch} rag"))

    # (g) the decode step against its byte bound, and one step profiled
    steps = n_req * new
    dec_s = out["serve"]["span_seconds"]["decode"]
    S = out["context_len"]
    specs = model.cache_specs(batch, S + new)
    nbytes = {k: int(np.prod(v.shape)) * v.dtype.itemsize
              for k, v in specs.items()}
    weights = sum(p.numel() * p.element_size()
                  for n, p in engine.compute_params.items() if n != "tok_embed")
    state = sum(b for k, b in nbytes.items() if k not in ("k", "v", "pos"))
    kv = sum(b for k, b in nbytes.items() if k in ("k", "v", "pos"))
    moved = weights + 2 * state + kv
    with torch.no_grad():
        cp = engine.compute_params
        ctx_d = torch.as_tensor(ctx, device=dev)
        _, cache = model.prefill(cp, {"tokens": ctx_d}, capacity=S + new)
        tok = torch.as_tensor(g1.tokens[:, :1], device=dev)
        t = torch.full((batch,), S, dtype=torch.int32, device=dev)

        def step():
            model.decode(cp, tok, cache, t)

        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof = profile_call(torch, step, time.perf_counter() - t0)
        del cache
    out["decode_step"] = {
        "ms": dec_s / steps * 1e3 if steps else None,
        "prefill_s_per_request": out["serve"]["span_seconds"]["prefill"] / n_req,
        "bound_ms": moved / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bytes": moved, "weight_bytes": weights, "state_bytes": state,
        "kv_bytes": kv, "profiled_step": prof}
    log(f"{arch} decode step against its bound: " + json.dumps(
        {k: v for k, v in out["decode_step"].items() if k != "profiled_step"}))
    log(f"{arch} profile, one decode step: " + json.dumps(prof))
    del pipe, engine
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def recurrent_rag_phase(torch, np, idx, eval_q, dev, n_req: int = 8,
                        batch: int = 32, prompt_len: int = 64,
                        doc_len: int = 128, new: int = 32,
                        cfgs=None) -> dict:
    """RAG serving with the recurrent families at full width and depth
    (phase 13): ``recurrent_rag`` for each of ``cfgs`` (default zamba2-1.2b
    and rwkv6-1.6b, published configs) in turn, each freed before the
    next.  Returns {arch: record, "check": [each one's ``check``],
    "seconds"}."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    if cfgs is None:
        cfgs = [get_config("zamba2-1.2b"), get_config("rwkv6-1.6b")]
    out = {"check": []}
    for cfg in cfgs:
        rec = recurrent_rag(torch, np, idx, eval_q, dev, cfg, n_req, batch,
                            prompt_len, doc_len, new)
        out["check"].append(rec.pop("check"))
        out[cfg.name] = rec
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# H100 SXM data sheet: dense bf16 tensor-core rate, the mfu denominator
PEAK_BF16_PER_S = 989e12
TRAIN_ARCH = "seamless-m4t-medium"
ENCDEC_ATTN = ("enc/wq", "enc/wk", "dec/wq", "dec/wk", "dec/xwq", "dec/xwk")
BACKWARD_ARCHS = ("gemma-2b", "qwen2-moe-a2.7b", "internvl2-26b",
                  "zamba2-1.2b", "rwkv6-1.6b", "seamless-m4t-medium")


def encdec_generate(torch, model, params, frames, prompt, new: int):
    """Greedy generation of ``new`` tokens after ``prompt`` given
    ``frames`` (all on the card).  Returns (tokens (B, new) numpy, every
    logit finite, prefill seconds, decode seconds a step)."""
    B, S = prompt.shape
    dev = prompt.device
    toks = []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"frames": frames,
                                               "tokens": prompt},
                                      capacity=S + new)
        finite = torch.isfinite(logits).all()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(new):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(tok)
            t = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            logits, cache = model.decode(params, tok[:, None], cache, t)
            finite = finite & torch.isfinite(logits).all()
        out = torch.stack(toks, 1).cpu().numpy()
        t2 = time.perf_counter()
    return out, bool(finite), t1 - t0, (t2 - t1) / new


def encdec_checks(torch, np, dev, cfg, batch: int = 4, frames_len: int = 512,
                  prompt_len: int = 128, new: int = 32) -> dict:
    """Check (a) of phase 14: ``cfg`` (seamless-m4t-medium at full width
    and depth) with weights drawn on the card (seed 0, float32, and their
    bf16 copy): two greedy generations of ``new`` tokens after a
    ``prompt_len``-token prompt and ``frames_len`` frames a row equal, every
    logit finite; prefill(S+1) against prefill(S) + one decode in float32
    and float64 (reported) and in float64 with every attention's wq / wk
    scaled to std 1/sqrt(d) (1e-6 relative); one decode step profiled and
    set beside its byte bound (the decoder's and ``lm_head``'s bf16
    weights, the cross K / V and the self-attention cache, read once)."""
    from repro_torch.models.common import count_params
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    model = build_model(cfg)
    n_params = count_params(model.param_table())
    out = {"arch": cfg.name, "params": n_params,
           "encoder_layers": cfg.encoder_layers, "layers": cfg.num_layers}
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    cp = model.compute_params(params)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.standard_normal(
        (batch, frames_len, cfg.d_model)).astype(np.float32), device=dev)
    prompt = torch.as_tensor(rng.integers(
        2, cfg.vocab_size, (batch, prompt_len), dtype=np.int32), device=dev)
    g1, fin1, pre_s, dec_s = encdec_generate(torch, model, cp, frames,
                                             prompt, new)
    g2, fin2, pre_s2, dec_s2 = encdec_generate(torch, model, cp, frames,
                                               prompt, new)
    require(fin1 and fin2, f"{cfg.name}: logits are not finite")
    require(np.array_equal(g1, g2),
            f"{cfg.name}: two greedy generations of one batch differ")
    out["generation"] = {"batch": batch, "frames": frames_len,
                         "prompt": prompt_len, "new": new,
                         "prefill_s": [pre_s, pre_s2],
                         "decode_ms": [dec_s * 1e3, dec_s2 * 1e3],
                         "tokens_first_row": g1[0, :8].tolist()}
    toks = torch.cat([prompt[:2], torch.as_tensor(g1[:2, :1], device=dev)], 1)
    # the drawn init makes every attention almost one-hot, which multiplies
    # rounding with depth even in float64; scaled, it does not, and that
    # comparison is gated
    scaled = attention_scale(cfg)
    checks = {}
    for key, dt, f in (("32", torch.float32, 1.0), ("64", torch.float64, 1.0),
                       ("64_attn_scaled", torch.float64, scaled)):
        m = build_model(cfg.with_(compute_dtype=str(dt).split(".")[-1]))
        p = m.compute_params({n: w.to(dt) * f if n in ENCDEC_ATTN else w.to(dt)
                              for n, w in params.items()})
        checks[f"prefill_decode_rel_err_{key}"] = chained_decode_rel(
            torch, m, p, toks, frames=frames[:2].to(dt))
        del m, p
        torch.cuda.empty_cache()
    err = checks["prefill_decode_rel_err_64_attn_scaled"]
    require(err <= 1e-6,
            f"{cfg.name}: float64 prefill(S+1) and prefill(S)+decode differ "
            f"by {err:.3g} relative > 1e-6 (attention weights scaled)")
    out["checks"] = checks
    # one decode step profiled, beside its byte bound
    with torch.no_grad():
        _, cache = model.prefill(cp, {"frames": frames, "tokens": prompt},
                                 capacity=prompt_len + new)
        tok = torch.as_tensor(g1[:, :1], device=dev)
        t = torch.full((batch,), prompt_len, dtype=torch.int32, device=dev)

        def step():
            model.decode(cp, tok, cache, t)

        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = profile_call(torch, step, wall)
        nb = {k: v.numel() * v.element_size() for k, v in cache.items()}
    weights = sum(w.numel() * w.element_size() for n, w in cp.items()
                  if n.startswith("dec/") or n in ("lm_head", "final_norm"))
    moved = weights + nb["xk"] + nb["xv"] + nb["enc_pos"] + nb["k"] + nb["v"] \
        + nb["pos"]
    out["decode_step"] = {
        "ms": dec_s2 * 1e3, "bound_ms": moved / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "bytes": moved, "weight_bytes": weights,
        "cross_kv_bytes": nb["xk"] + nb["xv"],
        "self_cache_bytes": nb["k"] + nb["v"] + nb["pos"],
        "profiled_step": prof}
    del cache, params, cp
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def attention_scale(cfg) -> float:
    """The factor that takes an attention's drawn wq / wk from std
    1/sqrt(H) to 1/sqrt(d), as the CPU parity tests scale them."""
    return (cfg.num_heads / cfg.d_model) ** 0.5


def attention_scaled_init(torch, cfg, seed: int = 0):
    """``init_state(model, optim, device)`` for ``launch.train.main``: the
    seed's draw with every enc-dec attention's wq / wk times
    ``attention_scale(cfg)``."""
    from repro_torch.train.loop import make_train_state

    f = attention_scale(cfg)

    def init_state(model, optim, device):
        gen = torch.Generator(device=device).manual_seed(seed)
        state = make_train_state(model, optim, gen, device=device)
        for n in ENCDEC_ATTN:
            state["params"][n].mul_(f)
        return state

    return init_state


def train_entry(torch, np, argv, init_state=None) -> dict:
    """Check (b) of phase 14: ``repro_torch.launch.train.main(argv,
    init_state=)`` on the card.  Every loss and grad norm finite; the
    median step after the first, tokens/s, peak memory and mfu
    (``model_flops_per_step`` over the step time, over the bf16 peak);
    then one more step of the trained state under the profiler."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import build_model, model_flops_per_step
    from repro_torch.train.loop import make_train_step

    args = launch_train.parse_args(argv)
    cfg = (get_reduced if args.reduced else get_config)(args.arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = launch_train.main(argv, init_state=init_state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    state = rec.pop("state")
    losses, gnorms = rec["losses"], rec["grad_norms"]
    require(all(np.isfinite(v) for v in losses + gnorms),
            f"train: a loss or grad norm is not finite ({losses}, {gnorms})")
    med = statistics.median(rec["step_seconds"][1:])
    B, S = rec["batch"], rec["seq"]
    flops = model_flops_per_step(cfg, ShapeSpec("train", "train", S, B))
    rec.update({"seconds": seconds, "median_step_s": med,
                "tokens_per_s": B * S / med,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "model_flops_per_step": flops,
                "flops_bound_s": flops / PEAK_BF16_PER_S,
                "mfu": flops / med / PEAK_BF16_PER_S})
    # one more step of the same run, profiled
    step = make_train_step(build_model(cfg), launch_train.optimizer_for(args),
                           num_microbatches=args.micro)
    batch = launch_train.batch_fn_for(
        cfg, TokenPipeline(DataConfig(cfg.vocab_size, S, B, seed=args.seed)),
        B, S)(args.steps)
    box = [state]

    def one():
        box[0], m = step(box[0], batch)
        float(m["loss"])

    rec["profiled_step"] = profile_call(torch, one, med)
    del state, box
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _leafwise_rel(torch, got: dict, want: dict) -> dict:
    """‖got − want‖ / ‖want‖ of each leaf, in float64."""
    out = {}
    for n, w in want.items():
        w64 = w.to(torch.float64)
        g64 = got[n].to(w64.device, torch.float64)
        den = float(torch.linalg.vector_norm(w64))
        out[n] = float(torch.linalg.vector_norm(g64 - w64)) / max(den, 1e-300)
    return out


def step_semantics(torch, dev, cfg, batch: int = 8, seq: int = 512,
                   lr: float = 0.1) -> dict:
    """Check (c) of phase 14, at ``cfg``'s full width in float32 compute on
    one batch of ``batch`` × ``seq``: one ``sgd`` step with 1 microbatch
    against one with 2, at the drawn init (the losses and the gradient
    norm, reported) and then with every attention's wq / wk scaled to std
    1/sqrt(d): ``repro``'s ``test_microbatch_equivalence`` tolerances (the
    loss within rtol 1e-4, the parameters within rtol 2e-3 / atol 2e-5)
    and every gradient leaf within 1e-4 relative; then 2 microbatches with
    ``remat`` on against off (every gradient leaf within 1e-6 relative)."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import batch_fn_for
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import global_norm, sgd

    t_phase = time.perf_counter()
    cfg = cfg.with_(compute_dtype="float32")
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    scale = attention_scale(cfg)
    data = batch_fn_for(cfg, TokenPipeline(DataConfig(cfg.vocab_size, seq,
                                                      batch)), batch, seq)(0)
    opt = sgd(lr=lr)

    def run(micro: int, remat: bool):
        seen = {}

        def keep(grads):
            seen.update(grads)
            return grads

        step = make_train_step(build_model(cfg.with_(remat=remat)), opt,
                               num_microbatches=micro, grad_transform=keep)
        st, m = step({"params": params, "opt": opt.init(params)}, data)
        return st["params"], seen, float(m["loss"])

    out = {"batch": batch, "seq": seq, "compute_dtype": "float32",
           "optimizer": f"sgd(lr={lr})"}
    # at the drawn init (reported): near one-hot attention turns the
    # microbatches' other rounding into other attention picks
    _, g, l1 = run(1, True)
    out["drawn_init"] = {"grad_norm": float(global_norm(g))}
    del g
    _, _, l2 = run(2, True)
    out["drawn_init"].update(loss_micro1=l1, loss_micro2=l2,
                             loss_rel=abs(l1 - l2) / abs(l1))
    for n in ENCDEC_ATTN:  # the checks below: attentions scaled
        params[n].mul_(scale)
    torch.cuda.empty_cache()
    p1, g1, l1 = run(1, True)
    p2, g2, l2 = run(2, True)
    out["loss"] = {"micro1": l1, "micro2": l2,
                   "rel": abs(l1 - l2) / abs(l1),
                   "grad_norm": float(global_norm(g1))}
    require(out["loss"]["rel"] <= 1e-4,
            f"train: loss with 2 microbatches off by {out['loss']['rel']:.3g} "
            "relative > 1e-4")
    excess = max(float(((p1[n] - p2[n]).abs()
                         - (2e-5 + 2e-3 * p2[n].abs())).max()) for n in p1)
    gm = _leafwise_rel(torch, g2, g1)
    out["params_max_excess_over_tol"] = excess
    out["grad_rel_micro"] = max(gm.values())
    require(excess <= 0.0, "train: parameters after a step with 2 "
            "microbatches outside rtol 2e-3 / atol 2e-5 of 1")
    require(out["grad_rel_micro"] <= 1e-4,
            f"train: a gradient leaf with 2 microbatches off by "
            f"{out['grad_rel_micro']:.3g} relative > 1e-4")
    del p1, g1
    torch.cuda.empty_cache()
    _, g3, l3 = run(2, False)
    gr = _leafwise_rel(torch, g3, g2)
    out["grad_rel_remat"] = max(gr.values())
    out["worst_remat_leaf"] = max(gr, key=gr.get)
    out["loss_no_remat"] = l3
    require(out["grad_rel_remat"] <= 1e-6,
            f"train: remat off against on, gradient leaf "
            f"{out['worst_remat_leaf']} off by {out['grad_rel_remat']:.3g} "
            "relative > 1e-6")
    del p2, g2, g3, params
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def family_backward(torch, dev, archs=BACKWARD_ARCHS, seq: int = 32,
                    batch: int = 2) -> dict:
    """Check (d) of phase 14: each family's reduced config in float64, the
    gradients of one train step (``make_train_step``, remat on) on the card
    against the same step on the CPU, every leaf within 1e-10 relative."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.model import build_model, make_inputs
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import sgd

    t_phase = time.perf_counter()
    out = {}
    for arch in archs:
        cfg = get_reduced(arch).with_(param_dtype="float64",
                                      compute_dtype="float64")
        require(cfg.moe is None or cfg.moe.impl == "dense",
                f"{arch}: not the dense dispatch")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        data = make_inputs(cfg, ShapeSpec("t", "train", seq, batch), seed=0,
                           device="cpu")
        grads, losses = [], []
        for d in ("cpu", dev):
            seen = {}

            def keep(g, seen=seen):
                seen.update(g)
                return g

            step = make_train_step(model, sgd(lr=0.0), grad_transform=keep)
            ps = {n: p.to(d) for n, p in params.items()}
            _, m = step({"params": ps, "opt": sgd().init(ps)}, data)
            grads.append(seen)
            losses.append(float(m["loss"]))
        rel = _leafwise_rel(torch, grads[1], grads[0])
        worst = max(rel, key=rel.get)
        out[arch] = {"leaves": len(rel), "worst_leaf": worst,
                     "worst_rel": rel[worst], "loss_cpu": losses[0],
                     "loss_cuda": losses[1]}
        require(rel[worst] <= 1e-10,
                f"{arch}: float64 gradient {worst} on the card off the CPU's "
                f"by {rel[worst]:.3g} relative > 1e-10")
    out["seconds"] = time.perf_counter() - t_phase
    return out


def resume_run(torch, path, fail_at, dev, steps: int = 8):
    """The reduced seamless-m4t-medium trained ``steps`` steps (batch 2 of
    32 frames and tokens, 2 microbatches, ``adamw`` on its warmup-cosine
    schedule, remat on) by a ``FaultTolerantRunner`` that checkpoints
    every 2 steps, with ``fail_at``'s failures injected.  Returns (state,
    restarts)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed.fault import FaultTolerantRunner, RunnerConfig
    from repro_torch.launch.train import batch_fn_for
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import (make_train_state, make_train_step,
                                        train_state_structure)
    from repro_torch.train.optim import adamw

    cfg = get_reduced(TRAIN_ARCH)
    model = build_model(cfg)
    optim = adamw(lr=3e-3, warmup=2, total_steps=steps)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 32, 2, seed=1))

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(0)
        return make_train_state(model, optim, gen, device=dev)

    runner = FaultTolerantRunner(
        RunnerConfig(str(path), ckpt_every=2),
        make_train_step(model, optim, num_microbatches=2),
        batch_fn_for(cfg, pipe, 2, 32), init_state, device=dev,
        structure=train_state_structure(model, optim))
    state, step = runner.run(steps, fail_at=fail_at)
    require(step == steps, f"resume: the runner stopped at step {step}")
    return state, runner.restarts


def _state_leaves(state, pre=""):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_state_leaves(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def fault_resume_child(src: str, work: str, dev: str = "cuda") -> dict:
    """Check (e) of phase 14, in a process of its own: cuBLAS's
    deterministic workspace is set before CUDA starts there, and
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` records
    any op of the step that has no deterministic CUDA implementation.  An
    uninterrupted run against one with failures injected at steps 3 and 5
    (``resume_run``): 2 restarts, and every leaf of the final state the
    same bits; where some op was recorded as nondeterministic, the
    resumed run no further from the uninterrupted one than a second
    uninterrupted run is."""
    import os
    import warnings

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    sys.path.insert(0, src)
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        clean, r0 = resume_run(torch, Path(work) / "clean", None, dev)
        resumed, r2 = resume_run(torch, Path(work) / "resumed",
                                 {3: 1, 5: 1}, dev)
    ops = sorted({str(w.message).split("\n")[0] for w in caught
                  if "deterministic" in str(w.message)})
    a, b = _state_leaves(clean), _state_leaves(resumed)
    diff = max(float((a[k].double() - b[k].double()).abs().max()) for k in a)
    out = {"restarts": [r0, r2], "leaves": len(a),
           "bit_equal": all(torch.equal(a[k], b[k]) for k in a),
           "max_abs_diff": diff, "nondeterministic_ops": ops}
    if ops:
        again, _ = resume_run(torch, Path(work) / "again", None, dev)
        c = _state_leaves(again)
        out["clean_vs_clean_max_abs_diff"] = max(
            float((a[k].double() - c[k].double()).abs().max()) for k in a)
    out["seconds"] = time.perf_counter() - t0
    return out


def fault_resume(torch, dev="cuda") -> dict:
    """Runs ``fault_resume_child`` in a spawned process (checkpoints under
    build/, removed after) and applies its checks."""
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase14-", dir=ROOT / "build"))
    try:
        with multiprocessing.get_context("spawn").Pool(1) as pool:
            out = pool.apply(fault_resume_child,
                             (str(ROOT / "src"), str(work), str(dev)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    require(out["restarts"] == [0, 2],
            f"resume: restarts {out['restarts']}, not [0, 2]")
    if out["nondeterministic_ops"]:
        require(out["max_abs_diff"] <= out["clean_vs_clean_max_abs_diff"],
                "resume: the resumed run is further from the uninterrupted "
                "one than two uninterrupted runs are from each other")
    else:
        require(out["bit_equal"], "resume: the resumed run's state differs "
                f"from the uninterrupted one's (max {out['max_abs_diff']:.3g})")
    return out


def train_phase(torch, np, dev, train_argv=None, cfg=None,
                backward_archs=BACKWARD_ARCHS) -> dict:
    """Phase 14: the enc-dec family and the training path on the card,
    (a) ``encdec_checks``, (b) ``train_entry``, (c) ``step_semantics``,
    (d) ``family_backward``, (e) ``fault_resume``; each frees its models
    before the next.  No kernel of the port is on this path."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    if cfg is None:
        cfg = get_config(TRAIN_ARCH)
    if train_argv is None:
        train_argv = ["--arch", TRAIN_ARCH, "--steps", "12", "--batch", "8",
                      "--seq", "512", "--micro", "2"]
    out = {}
    out["encdec"] = encdec_checks(torch, np, dev, cfg)
    log("phase 14 (a) enc-dec: " + json.dumps(out["encdec"]))
    # (b) at the drawn init, whose gradients explode with depth (reported),
    # then with the attentions scaled: there the loss must fall
    out["train_drawn_init"] = train_entry(torch, np, train_argv)
    log("phase 14 (b) train, drawn init: "
        + json.dumps(out["train_drawn_init"]))
    out["train"] = train_entry(torch, np, train_argv,
                               attention_scaled_init(torch, cfg))
    log("phase 14 (b) train, attentions scaled: " + json.dumps(out["train"]))
    losses = out["train"]["losses"]
    require(losses[-1] < losses[0],
            f"train: the last loss {losses[-1]:.4f} is not below the first "
            f"{losses[0]:.4f}")
    out["step_semantics"] = step_semantics(torch, dev, cfg)
    log("phase 14 (c) step semantics: " + json.dumps(out["step_semantics"]))
    out["backward"] = family_backward(torch, dev, backward_archs)
    log("phase 14 (d) backward on the card: " + json.dumps(out["backward"]))
    out["resume"] = fault_resume(torch, dev)
    log("phase 14 (e) resume: " + json.dumps(out["resume"]))
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phase 15: the partitioned index over ranks
# ---------------------------------------------------------------------------

PARTITIONS = ((2, 2), ("data", "model"))   # P = 4 ranks on one card
PART_KNOBS = dict(beam_width=64, max_hops=128, k=10)
PART_R = 16                                 # local knn_graph degree
# tests/test_distributed.py's cut, searched on the card and on the CPU
SMALL_CUT = dict(n=2048, hubs=64, queries=32,
                 knobs=dict(beam_width=32, max_hops=64, k=10))
RANK_TIMEOUT_S = 300


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def small_cut(np) -> dict:
    """The inputs of ``tests/test_distributed.py``'s sharded-search cut,
    drawn in the port: 2048 sift10m-like rows (seed 0), a tower drawn from
    a CPU generator (seed 0), 64 hubs (``default_rng(0)``) represented by
    the query tower, 32 queries (seed 5)."""
    import torch

    from repro_torch.core.twotower import TwoTowerConfig, init_params, query_tower
    from repro_torch.data.synthetic import make_database, make_queries_in_dist

    db, _ = make_database("sift10m-like", SMALL_CUT["n"], seed=0)
    tcfg = TwoTowerConfig(d_p=db.shape[1])
    params = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    hub_ids = np.random.default_rng(0).choice(SMALL_CUT["n"],
                                              SMALL_CUT["hubs"], replace=False)
    with torch.no_grad():
        reps = query_tower(params, tcfg, torch.from_numpy(db[hub_ids]))
    return {"db": db, "tcfg": tcfg,
            "params": {n: p.detach().numpy()
                       for n, p in params.as_dict().items()},
            "hub_ids": hub_ids, "hub_reps": reps.numpy(),
            "queries": make_queries_in_dist(db, SMALL_CUT["queries"], seed=5)}


def partition_rank(rank: int, world: int, init_file: str, src: str,
                   work: str, dev: str, t_spawn: float, out_q) -> None:
    """One rank of phase 15, in a process of its own: joins the gloo group
    (``file://`` rendezvous), reads the phase's inputs from
    ``work/args.pkl`` (which ``partition_phase`` wrote; a file, so the
    ranks start together: arguments of the spawn would hold the parent
    until each child had imported torch to read them), runs
    ``partition_checks`` and puts ``(rank, ok, result or traceback)`` on
    ``out_q``."""
    import datetime
    import pickle
    import traceback

    t_enter = time.time()
    try:
        sys.path.insert(0, src)
        import numpy as np
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)  # four ranks share the host's cores
        dev = torch.device(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        t_init = time.time()
        with open(Path(work) / "args.pkl", "rb") as f:
            args = pickle.load(f)
        try:
            out = partition_checks(torch, np, dist, rank, dev, Path(work),
                                   args)
        finally:
            dist.destroy_process_group()
        # the stages' seconds: from the spawn to this function (interpreter
        # and imports), to the joined group, then partition_checks' own
        out["stage_s"] = {"start": t_enter - t_spawn,
                          "torch_and_group": t_init - t_enter,
                          **out["stage_s"]}
        out_q.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — sent to the parent, raised there
        out_q.put((rank, False, traceback.format_exc()))


def partition_checks(torch, np, dist, rank, dev, work: Path, args) -> dict:
    """The body of ``partition_rank``: (a) this rank's shard of the index
    (its rows of ``work/db.npy``, a local ``knn_graph(R=16)`` built on
    ``dev``, its hubs), ``make_search_step`` over the eval queries, one
    warm call and three timed ones, then the merge alone timed three times
    on the same candidates; (b) the small cut searched on a ``dev`` mesh
    and on a CPU mesh; (c) ``cross_pod_grad_sync`` on a (2, 2) ("pod",
    "data") mesh of ``dev`` tensors; (d) one ``sgd`` step of the reduced
    gemma-2b in float32, data-parallel on ranks 0-1, and on rank 0 alone
    without a mesh."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.distributed import (
        build_sharded_gate, local_search, make_search_step, merge_top_k,
        mesh_all_gather, search_knobs, shard_index,
    )
    from repro_torch.distributed.sharding import ShardingCtx, make_profile
    from repro_torch.graphs.knn import knn_graph
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model, make_inputs
    from repro_torch.train.compress import cross_pod_grad_sync
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import sgd

    cuda = dev.type == "cuda"
    stage = {}
    t_stage = [time.perf_counter()]

    def mark(name):
        _sync(torch, dev)
        now = time.perf_counter()
        stage[name] = now - t_stage[0]
        t_stage[0] = now

    shape, axes = PARTITIONS
    mesh = make_host_mesh(shape, axes, device=dev.type)
    p = shard_index(mesh)
    out = {"shard": p, "stage_s": stage}
    mark("mesh")
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # (a) the partitioned index
    tcfg = args["tcfg"]
    db = np.load(work / "db.npy", mmap_mode="r")

    def local_graph(rows, R):
        _sync(torch, dev)
        t0 = time.perf_counter()
        g = knn_graph(rows, R, device=dev)
        out["graph_build_s"] = time.perf_counter() - t0
        return g

    sg = build_sharded_gate(mesh, db, (tcfg, args["params"]),
                            args["hub_reps"], args["hub_ids"], local_graph,
                            R=PART_R)
    mark("shard_and_graph")
    np.save(work / f"neighbors{p}.npy", sg.neighbors.cpu().numpy())
    out.update(hub_reps=sg.hub_reps.cpu().numpy(),
               hub_local_ids=sg.hub_local_ids.cpu().numpy(),
               offset=int(sg.offsets[0]))
    knobs = args["knobs"]
    step = make_search_step(mesh, tcfg, **knobs)
    q = torch.as_tensor(args["queries"], device=dev)
    if cuda:
        out["build_peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    step(sg, q)  # warm
    secs = []
    for _ in range(3):
        dist.barrier()
        _sync(torch, dev)
        t0 = time.perf_counter()
        ids, dists, hops = step(sg, q)
        _sync(torch, dev)
        secs.append(time.perf_counter() - t0)
    loc_ids, loc_d, _ = local_search(sg, q, tcfg, **search_knobs(**knobs))
    merge_secs = []
    for _ in range(3):
        dist.barrier()
        _sync(torch, dev)
        t0 = time.perf_counter()
        merged = merge_top_k(mesh_all_gather(loc_ids, mesh),
                             mesh_all_gather(loc_d, mesh), knobs["k"])
        _sync(torch, dev)
        merge_secs.append(time.perf_counter() - t0)
    out.update(step_s=secs, merge_s=merge_secs,
               ids=ids.cpu().numpy(), dists=dists.cpu().numpy(),
               merge_equal=bool(torch.equal(merged[0], ids)
                                and torch.equal(merged[1], dists)),
               mean_hops=float(hops.float().mean()),
               transport=str(loc_ids.device.type))
    if cuda:
        out["search_peak_bytes"] = torch.cuda.max_memory_allocated()
    del sg, q, ids, dists, loc_ids, loc_d, merged
    mark("searches_and_merges")

    # (b) the small cut on this device's mesh and on a CPU mesh
    small = args["small"]
    out["small"] = {}
    for side in ("dev", "cpu"):
        m = mesh if side == "dev" else make_host_mesh(shape, axes,
                                                      device="cpu")
        d = dev if side == "dev" else torch.device("cpu")
        sg_s = build_sharded_gate(
            m, small["db"], (small["tcfg"], small["params"]),
            small["hub_reps"], small["hub_ids"],
            lambda rows, R, d=d: knn_graph(rows, R, device=d), R=PART_R)
        got = make_search_step(m, small["tcfg"], **SMALL_CUT["knobs"])(
            sg_s, small["queries"])
        out["small"][side] = (got[0].cpu().numpy(), got[1].cpu().numpy())
    mark("small_cut")

    # (c) the cross-pod sync on this device's tensors
    pm = make_host_mesh((2, 2), ("pod", "data"), device=dev.type)
    pod = pm.get_coordinate()[0]
    g, _ = cross_pod_grad_sync({"w": torch.full((8,), float(pod), device=dev)},
                               {"w": torch.zeros(8, device=dev)}, pm,
                               axis="pod")
    out["cross_pod"] = g["w"].cpu().numpy()
    mark("cross_pod")

    # (d) the data-parallel train step on ranks 0-1 (every rank builds the
    # mesh: its groups are made collectively)
    dm = make_host_mesh((2,), ("data",), device=dev.type)
    if rank < 2:
        cfg = get_reduced(args["train_arch"]).with_(compute_dtype="float32")
        model = build_model(cfg)
        rows, seq = args["train_shape"]
        batch = make_inputs(cfg, ShapeSpec("t", "train", seq, rows), seed=0,
                            device=dev)

        def one_step(ctx):
            params = model.init(torch.Generator(device=dev).manual_seed(0))
            opt = sgd(1e-2)
            kw = {} if ctx is None else {"ctx": ctx}
            st, m = make_train_step(model, opt, **kw)(
                {"params": params, "opt": opt.init(params)}, batch)
            return float(m["loss"]), {n: v.cpu().numpy()
                                      for n, v in st["params"].items()}

        out["train_dp"] = one_step(ShardingCtx(dm, make_profile("train")))
        if rank == 0:
            out["train_single"] = one_step(None)
    dist.barrier()
    mark("train")
    return out


def run_partition_ranks(np, work: Path, dev, args: dict, world: int) -> list:
    """Writes ``args`` to ``work/args.pkl``, spawns ``world`` ranks of
    ``partition_rank`` (rendezvous file under ``work``) and returns their
    results in rank order; raises with a rank's traceback, or if the ranks
    do not finish in ``RANK_TIMEOUT_S``.  Every process is stopped however
    this ends."""
    import pickle
    import queue

    with open(work / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    t_spawn = time.time()
    procs = [ctx.Process(target=partition_rank,
                         args=(r, world, str(work / "rendezvous"),
                               str(ROOT / "src"), str(work), str(dev),
                               t_spawn, out_q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while len(results) < world:
            try:
                rank, ok, res = out_q.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise RuntimeError(f"phase 15: {world - len(results)} ranks "
                                   f"did not finish in {RANK_TIMEOUT_S} s"
                                   ) from None
            require(ok, f"phase 15: rank {rank} failed:\n{res}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    return [results[r] for r in range(world)]


def partition_reference(torch, np, db, tcfg, params, ranks, work: Path,
                        queries, knobs, dev):
    """The four shards' searches composed in this one process: each shard
    from its rows, the neighbours its rank built and the hubs it kept,
    ``local_search`` with the step's knobs, then ``merge_top_k``."""
    from repro_torch.core.distributed import (
        ShardedGate, local_search, merge_top_k, search_knobs,
    )

    k = knobs["k"]
    knobs = search_knobs(**knobs)
    tp = {n: torch.as_tensor(np.asarray(v, np.float32), device=dev)
          for n, v in params.items()}
    q = torch.as_tensor(queries, device=dev)
    per = len(db) // len(ranks)
    cand_ids, cand_d = [], []
    for r in sorted(ranks, key=lambda r: r["shard"]):
        lo = r["offset"]
        rows = np.asarray(db[lo:lo + per])
        sg = ShardedGate(
            db=torch.as_tensor(rows, device=dev),
            db_norms=torch.as_tensor(
                np.sum(rows.astype(np.float32) ** 2, axis=1), device=dev),
            neighbors=torch.as_tensor(
                np.load(work / f"neighbors{r['shard']}.npy"), device=dev),
            hub_reps=torch.as_tensor(r["hub_reps"], device=dev),
            hub_local_ids=torch.as_tensor(r["hub_local_ids"], device=dev),
            tower_params=tp,
            offsets=torch.tensor([lo], dtype=torch.int32, device=dev))
        ids, d, _ = local_search(sg, q, tcfg, **knobs)
        cand_ids.append(ids)
        cand_d.append(d)
        del sg
    ids, d = merge_top_k(torch.stack(cand_ids), torch.stack(cand_d), k)
    return ids.cpu().numpy(), d.cpu().numpy()


def partition_phase(torch, np, db, tower, hubs, eval_q, gt, dev,
                    knobs=PART_KNOBS, train_arch: str = "gemma-2b",
                    train_shape=(8, 128)) -> dict:
    """Phase 15: the partitioned GATE index (``repro_torch.core.
    distributed``) on 4 gloo ranks of a (2, 2) ("data", "model") mesh
    sharing ``dev``, each owning a contiguous quarter of ``db``; ``tower``
    is (TwoTowerConfig, parameters) and ``hubs`` (ids, representations),
    phase 4's.  Gates: the merged ids and distances the same on every rank
    and equal to this process's composition of the four shards' searches
    (bits); distances ascending, ids unique per row and in [0, N); at the
    small cut the ``dev`` mesh's ids on at least 99% of the CPU mesh's
    slots and its distances within 1e-4 of their largest; the cross-pod
    sync 0.5 within 0.02 on every rank; the data-parallel step's loss
    within 1e-6 relative of the one-rank step's and its parameters within
    rtol 2e-3 / atol 2e-5.  Reports recall@10 against ``gt``, QPS, the
    merge's share of a step, each rank's peak allocation and graph build
    seconds, and the phase's seconds."""
    t_phase = time.perf_counter()
    tcfg, params = tower
    params = {n: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for n, v in dict(params).items()}
    world = int(np.prod(PARTITIONS[0]))
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase15-", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        np.save(work / "db.npy", np.asarray(db))
        save_s = time.perf_counter() - t0
        args = {"tcfg": tcfg, "params": params,
                "hub_ids": np.asarray(hubs[0]),
                "hub_reps": np.asarray(hubs[1], np.float32),
                "queries": np.asarray(eval_q, np.float32),
                "small": small_cut(np), "train_arch": train_arch,
                "train_shape": tuple(train_shape), "knobs": dict(knobs)}
        t0 = time.perf_counter()
        ranks = run_partition_ranks(np, work, dev, args, world)
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want_ids, want_d = partition_reference(torch, np, db, tcfg, params,
                                               ranks, work, eval_q, knobs,
                                               dev)
        ref_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = _partition_gates(np, ranks, want_ids, want_d, len(db), gt)
    out.update(ranks=world, mesh=list(PARTITIONS[0]), axes=PARTITIONS[1],
               rows_per_rank=len(db) // world, queries=len(eval_q),
               knobs=dict(knobs), local_graph_R=PART_R,
               db_save_s=save_s, ranks_wall_s=ranks_s, reference_s=ref_s,
               seconds=time.perf_counter() - t_phase)
    return out


def _partition_gates(np, ranks, want_ids, want_d, n, gt) -> dict:
    """Phase 15's checks on the ranks' results; returns the record."""
    from repro_torch.graphs.knn import recall_at_k

    ids, dists = ranks[0]["ids"], ranks[0]["dists"]
    for r in ranks[1:]:
        require(np.array_equal(r["ids"], ids)
                and np.array_equal(r["dists"], dists),
                f"phase 15: rank {r['shard']}'s merged result differs")
    require(all(r["merge_equal"] for r in ranks),
            "phase 15: the merge alone differs from the step's")
    require(np.array_equal(ids, want_ids) and np.array_equal(dists, want_d),
            "phase 15: the merged ids / distances differ from the "
            "single-process composition of the four shards' searches")
    require(bool((np.diff(dists, axis=1) >= 0).all()),
            "phase 15: distances do not ascend along a row")
    require(all(len(set(row.tolist())) == len(row) for row in ids),
            "phase 15: an id repeats within a row")
    require(ids.min() >= 0 and ids.max() < n,
            f"phase 15: an id outside [0, {n})")
    s_dev, s_cpu = (ranks[0]["small"][k] for k in ("dev", "cpu"))
    agree = float((s_dev[0] == s_cpu[0]).mean())
    d_rel = float(np.abs(s_dev[1] - s_cpu[1]).max() / np.abs(s_cpu[1]).max())
    require(agree >= 0.99,
            f"phase 15: small cut, ids agree with the CPU's on {agree:.4f}")
    require(d_rel <= 1e-4,
            f"phase 15: small cut, distances off the CPU's by {d_rel:.3g}")
    cross = [float(np.abs(r["cross_pod"] - 0.5).max()) for r in ranks]
    require(max(cross) <= 0.02,
            f"phase 15: cross_pod_grad_sync off 0.5 by {max(cross):.3g}")
    (l_dp, p_dp), (l_1, p_1) = ranks[0]["train_dp"], ranks[0]["train_single"]
    require(ranks[1]["train_dp"][0] == l_dp,
            "phase 15: the two data-parallel ranks' losses differ")
    loss_rel = abs(l_dp - l_1) / abs(l_1)
    excess = max(float((np.abs(p_dp[k] - p_1[k])
                        - (2e-5 + 2e-3 * np.abs(p_1[k]))).max()) for k in p_1)
    require(loss_rel <= 1e-6,
            f"phase 15: data-parallel loss off by {loss_rel:.3g} relative")
    require(excess <= 0.0, "phase 15: data-parallel parameters outside "
            "rtol 2e-3 / atol 2e-5 of the one-rank step's")
    step = [statistics.median(r["step_s"]) for r in ranks]
    merge = [statistics.median(r["merge_s"]) for r in ranks]
    return {
        "recall_at_10": float(recall_at_k(ids, gt, 10)) if gt is not None
        else None,
        "qps": len(ids) / max(step),
        "step_s": [r["step_s"] for r in ranks],
        "merge_s": [r["merge_s"] for r in ranks],
        "merge_share": max(merge) / max(step),
        "mean_hops": [r["mean_hops"] for r in ranks],
        "graph_build_s": [r["graph_build_s"] for r in ranks],
        "build_peak_bytes": [r.get("build_peak_bytes") for r in ranks],
        "search_peak_bytes": [r.get("search_peak_bytes") for r in ranks],
        "transport": ranks[0]["transport"],
        "stage_s": [r["stage_s"] for r in ranks],
        "small_cut": {"id_agreement": agree, "dist_rel": d_rel},
        "cross_pod_max_err": max(cross),
        "train": {"loss_dp": l_dp, "loss_single": l_1, "loss_rel": loss_rel,
                  "params_max_excess_over_tol": excess},
    }


# ---------------------------------------------------------------------------
# Phase 16: the dry-run tooling
# ---------------------------------------------------------------------------

# production cells dry-run on the 16x16 fake mesh, one subprocess each
DRYRUN_CELLS = (("gate-anns", "search_1b"), ("gate-anns", "search_rag"),
                ("gemma-2b", "decode_32k"))
# phase 15's step as one rank of its (2, 2) mesh runs it
PHASE15_CELL = dict(rows=250_000, d=128, R=PART_R, hubs=16, batch=10_000,
                    **PART_KNOBS)
RATE_SHAPES = dict(matmul=8192, copy_bytes=4 << 30)
# phase 11's requests, as many as keep the whole smoke inside 900 s
RAG_REQUESTS = 8
DRYRUN_TIMEOUT_S = 300
# sharded train steps on a (4, 4) fake mesh, 16 rows of 128 tokens in 2
# microbatches: the reduced llama3-8b at a vocabulary of 16,384 (logits
# sharded on the vocabulary), the reduced zamba2-1.2b (its causal conv's
# backward on a sharded DTensor), the reduced rwkv6-1.6b (the WKV scan and
# its LoRAs), the reduced mistral-large-123b at 4 rows (microbatches of 2
# rows, which do not divide the 4-way "data" axis: each row's sequence is
# folded into 4 rows), the reduced seamless-m4t-medium at a vocabulary of
# 16,386 (which does not divide the 4-way "model" axis: the head and the
# cross entropy on each rank's own block of it; its weights hold the whole
# vocabulary, as ``repro``'s rules lay them out, and no activation does)
# the reduced qwen2.5-32b at 10 query and 2 KV heads (10 over the
# 4-way "model" axis is production's 40 over 16: each rank its own block
# of heads) and the reduced qwen2-moe-a2.7b with the dropping dispatch at a
# vocabulary of 16,384 (each "data" rank sorts, scatters and combines its
# own group's tokens; the reduced vocabulary, 512, is a group's 256 tokens
# times their 2 experts, which the whole-vocabulary check would take for
# it); each with ``repro``'s compiled temp bytes, collective bytes
# and dot FLOPs a device (XLA on 16 CPU placeholder devices;
# tests/test_torch_cells.py and tests/test_torch_cells_excess.py compile
# them and hold them to these numbers) and the most dot FLOPs the port may
# take beside ``repro``'s (zamba2-1.2b's Mamba backward on the CPU's torch
# runs more)
TRAIN44_CELLS = {
    "llama3-8b": dict(vocab_size=16384, repro_temp=26_958_600,
                      repro_coll=33_679_296, repro_dot=2_147_483_648,
                      dot_ratio=1.1),
    "zamba2-1.2b": dict(vocab_size=None, repro_temp=11_047_360,
                        repro_coll=25_573_632, repro_dot=936_968_192,
                        dot_ratio=1.5),
    "rwkv6-1.6b": dict(vocab_size=None, repro_temp=6_790_144,
                       repro_coll=20_363_296, repro_dot=755_204_096,
                       dot_ratio=1.1),
    "mistral-large-123b": dict(vocab_size=None, batch=4,
                               repro_temp=2_072_200, repro_coll=13_886_088,
                               repro_dot=228_589_568, dot_ratio=1.1),
    "seamless-m4t-medium": dict(vocab_size=16386, whole_vocab=True,
                                repro_temp=100_232_736,
                                repro_coll=95_285_168,
                                repro_dot=5_805_506_560, dot_ratio=1.1),
    "qwen2.5-32b": dict(vocab_size=None,
                        config=dict(num_heads=10, num_kv_heads=2),
                        repro_temp=9_435_768, repro_coll=12_228_528,
                        repro_dot=1_560_281_088, dot_ratio=1.1),
    "qwen2-moe-a2.7b": dict(vocab_size=16384, moe=dict(impl="dropping"),
                            repro_temp=27_116_328, repro_coll=47_746_952,
                            repro_dot=2_319_253_504, dot_ratio=1.1),
}
TRAIN44_SHAPE = dict(seq=128, batch=16, micro=2, mesh=(4, 4))
# the smallest train cells, priced in one process in turn: one
# interpreter's start and imports fewer beside the other cells'
# processes on the machine's cores
TRAIN44_SHARED = ("mistral-large-123b", "qwen2.5-32b", "qwen2-moe-a2.7b")
# the most temp and collective bytes the port's steps may take beside
# ``repro``'s
TRAIN44_TEMP_RATIO = 1.5
TRAIN44_COLL_RATIO = 1.5
# one decode step on the (4, 4) fake mesh, 16 rows of a 128-slot cache,
# with ``repro``'s compiled collective bytes a device and the most the
# port may move beside them (``TRAIN44_COLL_RATIO`` unless the cell sets
# ``coll_ratio``): the reduced llama3-8b at a vocabulary of 16,384 (the
# lookup and the head keep the vocabulary sharded: no op makes the whole
# table), and the reduced rwkv6-1.6b, zamba2-1.2b and seamless-m4t-medium
# (the recurrent states and the self- and cross-attention over a cache
# split on its sequence, each on its rank's shards)
DECODE44_SHAPE = dict(seq=128, batch=16, mesh=(4, 4), kind="decode")
DECODE44_CELLS = {
    "llama3-8b": dict(vocab_size=16384, repro_coll=2_509_840),
    "rwkv6-1.6b": dict(vocab_size=None, repro_coll=570_128, coll_ratio=1.1),
    "zamba2-1.2b": dict(vocab_size=None, repro_coll=529_424,
                        coll_ratio=1.1),
    "seamless-m4t-medium": dict(vocab_size=None, repro_coll=462_352),
}

PHASE15_PRICING = """
import dataclasses, json, sys, torch
from repro_torch.core.distributed import (
    gate_shardings, make_search_step, sharded_gate_specs)
from repro_torch.core.twotower import TwoTowerConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.launch.cells import Cell, lower_cell
from repro_torch.launch.dryrun import init_fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.roofline import roofline_row
from repro_torch.models.common import TensorSpec
c, dev = json.loads(sys.argv[1]), sys.argv[2]
init_fake_world(4)
mesh = make_host_mesh((2, 2), ("data", "model"), device=dev)
tcfg = TwoTowerConfig(d_p=c["d"])
step = make_search_step(mesh, tcfg, beam_width=c["beam_width"],
                        max_hops=c["max_hops"], k=c["k"])
specs = sharded_gate_specs(mesh, tcfg, n_total=4 * c["rows"], d=c["d"],
                           R=c["R"], hubs_per_shard=c["hubs"],
                           dtype=torch.float32)
sh = gate_shardings(mesh)
cell = Cell(name="phase15", fn=step,
            args=(specs, TensorSpec((c["batch"], c["d"]), torch.float32)),
            in_shardings=(sh, sh.tower_params), out_shardings=None,
            donate_argnums=(), fallbacks=[], ctx=ShardingCtx(), local=True)
tr = lower_cell(cell)
rec = {"arch": "phase15", "shape": "step", "mesh": "2x2", "n_devices": 4,
       "model_flops": 0.0, "hlo": tr.cost_analysis(),
       **dataclasses.asdict(tr.memory_analysis())}
print("JSON", json.dumps(roofline_row(rec)))
"""


# one cell's job (a JSON object) or several on one mesh (a JSON list, run
# in turn in one process): a "JSON" line for each, in order
CELL44_PRICING = """
import dataclasses, json, sys
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.cells import build_cell, lower_cell
from repro_torch.launch.dryrun import init_fake_world
from repro_torch.launch.mesh import make_host_mesh
jobs, dev = json.loads(sys.argv[1]), sys.argv[2]
jobs = jobs if isinstance(jobs, list) else [jobs]
rows, cols = jobs[0]["mesh"]
init_fake_world(rows * cols)
mesh = make_host_mesh((rows, cols), device=dev)
def shapes(spec):
    if spec and isinstance(spec[1], str):
        return [spec[0]]
    return [s for x in spec or [] for s in shapes(x)]
for c in jobs:
    cfg = get_reduced(c["arch"]).with_(**c.get("config", {}))
    if c.get("moe"):
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **c["moe"]))
    if c["vocab_size"]:
        cfg = cfg.with_(vocab_size=c["vocab_size"])
    V = cfg.vocab_size
    kind = c.get("kind", "train")
    shape = ShapeSpec(f"{kind}_44", kind, c["seq"], c["batch"])
    cell = build_cell(cfg, shape, mesh, num_microbatches=c.get("micro"))
    tr = lower_cell(cell)
    h = tr.cost_analysis()
    # ops whose outputs have the whole vocabulary as a dimension (where
    # the cell sets a vocabulary no other dimension has; else as the
    # last), and of those the ones no weight could be: beside the
    # vocabulary more than a (V, d) weight's shard or gathered whole has
    def whole_vocab(s):
        return V in s if c["vocab_size"] else s[-1] == V
    def weight_like(s):
        return len(s) == 2 and cfg.d_model % (s[0] * s[1] // V) == 0
    whole = {}
    for run in tr.runs:
        for r in run:
            if r[1] == "op":
                whole.setdefault(r[0], []).extend(
                    s for o in r[2] for s in shapes(o) if s and whole_vocab(s))
    print("JSON", json.dumps({**dataclasses.asdict(tr.memory_analysis()),
                              "collective_bytes": h["collective_bytes"],
                              "collectives": h["collectives"],
                              "dot_flops": h["dot_flops"],
                              "whole_vocab_ops": sorted(
                                  k for k, v in whole.items() if v),
                              "vocab_act_ops": sorted(
                                  k for k, v in whole.items()
                                  if any(not weight_like(s) for s in v)),
                              "fallbacks": cell.fallbacks + tr.fallbacks}),
          flush=True)
"""


def cell44_jobs(train44=TRAIN44_CELLS, decode44=DECODE44_CELLS) -> dict:
    """``CELL44_PRICING``'s argument for each 4x4 cell, by its key in the
    phase (``train44:ARCH``, ``decode44:ARCH``): a train cell at
    ``TRAIN44_SHAPE`` (its own rows and microbatch count where it sets
    them), a decode cell at ``DECODE44_SHAPE``."""
    jobs = {f"train44:{a}": {"arch": a, "vocab_size": c["vocab_size"],
                             **TRAIN44_SHAPE,
                             **{k: c[k] for k in ("batch", "micro",
                                                  "config", "moe")
                                if k in c}}
            for a, c in train44.items()}
    jobs.update({f"decode44:{a}": {"arch": a, "vocab_size": c["vocab_size"],
                                   **DECODE44_SHAPE}
                 for a, c in decode44.items()})
    return jobs


def _dryrun_env():
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def gemma_decode_arg_bytes(cfg, batch: int, seq: int, data: int = 16,
                           model: int = 16) -> int:
    """gemma-2b's decode cell's argument bytes a device on the (data,
    model) mesh, by hand from the decode profile: the embedding over vocab
    x embed, the MLP over embed x ff, the attention over embed only (8
    heads do not divide 16: replicated), norms whole; the tokens and ``t``
    over the batch; the cache over batch x sequence."""
    L, d, H, Hkv, hd, ff, V = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                               cfg.num_kv_heads, cfg.head_dim, cfg.d_ff,
                               cfg.vocab_size)
    f32 = 4
    params = (V * d / (data * model) + d + 2 * L * d
              + L * d * (H + 2 * Hkv) * hd / data + L * H * hd * d / data
              + 3 * L * d * ff / (data * model)) * f32
    cache = 2 * L * batch * seq * Hkv * hd * 2 / (data * model)
    return int(params + cache + batch * seq * 4 / (data * model)
               + 2 * batch * 4 / data)


def gate_arg_bytes(shape, n_devices: int = 256) -> int:
    """A gate cell's argument bytes a device: the rank's rows (bf16), norms,
    graph, 64 hubs and their ids, its offset; the query tower's four
    leaves (the hub tower is never read); the queries (bf16)."""
    n, d = shape.n_total // n_devices, shape.d
    shard = n * d * 2 + n * 4 + n * shape.R * 4 + 64 * 128 * 4 + 64 * 4 + 4
    tower = (d * 256 + 256 + 256 * 128 + 128) * 4
    return shard + tower + shape.batch * d * 2


def matmul_and_copy_rates(torch, dev, shapes=None) -> dict:
    """The card's achieved dense bf16 ``torch.matmul`` rate at n³ and one
    device copy's bytes a second (read and write), medians of CUDA-event
    pairs."""
    shapes = shapes or RATE_SHAPES
    n = shapes["matmul"]
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(n, n, device=dev, dtype=torch.bfloat16, generator=g)
    b = torch.randn(n, n, device=dev, dtype=torch.bfloat16, generator=g)
    mm_ms = cuda_ms(torch, lambda i: torch.matmul(a, b), reps=10)
    del a, b
    src = torch.empty(shapes["copy_bytes"], dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    cp_ms = cuda_ms(torch, lambda i: dst.copy_(src), reps=10)
    del src, dst
    return {"matmul_n": n, "matmul_ms": mm_ms,
            "matmul_flops_per_s": 2.0 * n ** 3 / (mm_ms * 1e-3),
            "copy_bytes": shapes["copy_bytes"], "copy_ms": cp_ms,
            "copy_bytes_per_s": 2.0 * shapes["copy_bytes"] / (cp_ms * 1e-3)}


def dryrun_phase(torch, np, dev, phase15_step_s: float,
                 cells=DRYRUN_CELLS, p15=PHASE15_CELL,
                 train44=TRAIN44_CELLS, decode44=DECODE44_CELLS) -> dict:
    """Phase 16: (a) ``python -m repro_torch.launch.dryrun`` for each of
    ``cells`` on the 16x16 fake mesh (fake tensors on ``dev``'s type), in
    parallel subprocesses: every one exits 0 with ``ok``, its argument
    bytes a device equal the hand count, a gate cell's collective bytes
    equal ``mesh_all_gather``'s per-dimension gathers of its (B, k) ids and
    distances, useful_ratio <= 1 and every row fits 80 GiB; the roofline
    rows are printed.  (b) Beside them, phase 15's own step priced on a
    (2, 2) fake mesh at phase 15's shapes: ``phase15_step_s`` (the
    slowest rank's median) must not beat 4x the per-rank bound (four
    ranks share the card).  (c) The card's bf16 matmul and copy rates
    beside the roofline's constants; a reading over 105% of a constant
    fails.  (d) Beside (a), each of ``train44``'s sharded train steps on
    its fake mesh (``TRAIN44_SHAPE``): it dry-runs, its temp bytes a
    device at most ``TRAIN44_TEMP_RATIO`` times ``repro``'s compiled ones,
    its collective bytes at most ``TRAIN44_COLL_RATIO`` times and its dot
    FLOPs at most the cell's ``dot_ratio`` times ``repro``'s, an MoE
    cell (``moe`` set) records no op rescued by ``ReplicateFallback``, and
    no op has the whole vocabulary as a dimension (in a ``whole_vocab`` cell, whose
    vocabulary the mesh does not divide, no op but one shaped as a weight
    of it); and each of ``decode44``'s decode steps (``DECODE44_SHAPE``):
    it dry-runs, makes no op of the whole vocabulary and moves at most its
    ``coll_ratio`` (``TRAIN44_COLL_RATIO``) times ``repro``'s collective
    bytes; the bytes and collective bytes of each logged."""
    from repro_torch.launch import gate_cell, roofline
    from repro_torch.configs import get_config, SHAPES

    t_phase = time.perf_counter()
    env = _dryrun_env()
    (ROOT / "build").mkdir(exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(prefix="phase16-", dir=ROOT / "build"))
    procs = {}
    try:
        for arch, shape in cells:
            procs[(arch, shape)] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--out", str(out_dir),
                 "--device", dev.type],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=ROOT)
        procs["phase15"] = subprocess.Popen(
            [sys.executable, "-c", PHASE15_PRICING, json.dumps(p15),
             dev.type], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=ROOT)
        # a process for each train cell but those of ``TRAIN44_SHARED``,
        # which take one in turn, and one for the decode cells in turn
        jobs = cell44_jobs(train44, decode44)
        train = [k for k in jobs if k.startswith("train44:")]
        shared = [k for k in train if k.split(":")[1] in TRAIN44_SHARED]
        groups = [[k] for k in train if k not in shared] + [shared] + [
            [k for k in jobs if k.startswith("decode44:")]]
        for keys in filter(None, groups):
            procs[tuple(keys)] = subprocess.Popen(
                [sys.executable, "-c", CELL44_PRICING,
                 json.dumps([jobs[k] for k in keys]), dev.type],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=ROOT)
        # (c) on the card while the dry runs keep the host busy
        rates = (matmul_and_copy_rates(torch, dev) if dev.type == "cuda"
                 else None)
        done = {}
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        for key, p in procs.items():
            so, se = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
            require(p.returncode == 0,
                    f"phase 16: {key} exited {p.returncode}:\n"
                    f"{so[-3000:]}\n{se[-3000:]}")
            done[key] = so
        records = {c: json.loads((out_dir / f"{c[0]}__{c[1]}__16x16.json")
                                 .read_text()) for c in cells}
        # each 4x4 cell's JSON line by its key
        cell44 = {k: json.loads(ln[5:]) for keys, so in done.items()
                  if isinstance(keys, tuple)
                  for k, ln in zip(keys, [ln for ln in so.splitlines()
                                          if ln.startswith("JSON ")])}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    dryrun_s = time.perf_counter() - t_phase

    rows = []
    checks = {}
    for (arch, shape), rec in records.items():
        require(rec.get("ok") and not rec.get("skipped"),
                f"phase 16: {arch} {shape} not ok: {rec.get('error')}")
        row = roofline.roofline_row(rec)
        rows.append(row)
        if arch == "gate-anns":
            gs = gate_cell.GATE_SHAPES[shape]
            want_args = gate_arg_bytes(gs)
            want_coll = 2 * (16 + 256) * gs.batch * gs.k * 4
            require(rec["hlo"]["collective_bytes"] == want_coll,
                    f"phase 16: {shape}'s collective bytes "
                    f"{rec['hlo']['collective_bytes']} != {want_coll}")
        else:
            sp = SHAPES[shape]
            want_args = gemma_decode_arg_bytes(get_config(arch),
                                               sp.global_batch, sp.seq_len)
        require(rec["argument_size_in_bytes"] == want_args,
                f"phase 16: {arch} {shape}'s argument bytes "
                f"{rec['argument_size_in_bytes']} != {want_args}")
        require(0 < row["useful_ratio"] <= 1.0,
                f"phase 16: {arch} {shape}'s useful ratio "
                f"{row['useful_ratio']:.3g}")
        require(row["fits_hbm"],
                f"phase 16: {arch} {shape} needs {row['mem_gib_per_dev']:.1f}"
                f" GiB a device")
        checks[f"{arch}:{shape}"] = {
            "argument_size_in_bytes": rec["argument_size_in_bytes"],
            "total_s": rec["total_s"], "fallbacks": rec["fallbacks"],
            "collectives": rec["hlo"]["collectives"]}
    log("phase 16 roofline (16x16 fake mesh, H100 constants):\n"
        + roofline.render_markdown(rows))

    p15_row = json.loads([ln for ln in done["phase15"].splitlines()
                          if ln.startswith("JSON ")][-1][5:])
    per_rank = max(p15_row["compute_s"], p15_row["memory_s"],
                   p15_row["collective_s"])
    log(f"phase 16: phase 15's step {phase15_step_s * 1e3:.2f} ms against "
        f"4 x its per-rank bound {4 * per_rank * 1e3:.3f} ms "
        f"({p15_row['dominant']}-bound)")
    require(phase15_step_s >= 4 * per_rank,
            "phase 16: phase 15's measured step beats 4x its roofline "
            "bound: the analysis counts work the step does not do")

    t44s = {}
    for arch, c in train44.items():
        t44 = cell44[f"train44:{arch}"]
        t44["temp_vs_repro"] = ratio = \
            t44["temp_size_in_bytes"] / c["repro_temp"]
        t44s[arch] = t44
        log(f"phase 16: {arch} train step on a {TRAIN44_SHAPE['mesh']} fake "
            f"mesh ({c.get('micro', TRAIN44_SHAPE['micro'])} microbatches"
            + "".join(f", moe.{k}={v}" for k, v in c.get("moe", {}).items())
            + "): "
            f"argument / output / temp bytes a device "
            f"{t44['argument_size_in_bytes']} / "
            f"{t44['output_size_in_bytes']} / {t44['temp_size_in_bytes']} "
            f"({ratio:.3f}x repro's compiled {c['repro_temp']}); collective "
            f"bytes {t44['collective_bytes']:.0f} "
            f"{json.dumps(t44['collectives'])}")
        t44["coll_vs_repro"] = coll = \
            t44["collective_bytes"] / c["repro_coll"]
        t44["dot_vs_repro"] = dot = t44["dot_flops"] / c["repro_dot"]
        log(f"phase 16: {arch} train step: collective bytes {coll:.3f}x "
            f"repro's {c['repro_coll']}, dot FLOPs {t44['dot_flops']:.0f} "
            f"({dot:.3f}x repro's {c['repro_dot']})")
        require(ratio <= TRAIN44_TEMP_RATIO,
                f"phase 16: the {arch} train cell's temp is {ratio:.3f}x "
                f"repro's (limit {TRAIN44_TEMP_RATIO})")
        require(coll <= TRAIN44_COLL_RATIO,
                f"phase 16: the {arch} train cell's collective bytes are "
                f"{coll:.3f}x repro's (limit {TRAIN44_COLL_RATIO})")
        require(dot <= c["dot_ratio"],
                f"phase 16: the {arch} train cell's dot FLOPs are {dot:.3f}x "
                f"repro's (limit {c['dot_ratio']})")
        if c.get("moe"):  # no op of the dispatch rescued by replication
            ops = [f for f in t44["fallbacks"] if f.startswith("op/")]
            require(not ops, f"phase 16: the {arch} train cell replicates "
                    f"{ops}")
        wv = t44["vocab_act_ops" if c.get("whole_vocab")
                 else "whole_vocab_ops"]
        require(not wv, f"phase 16: the {arch} train cell holds the whole "
                f"vocabulary in {wv}")
    d44s = {}
    for arch, c in decode44.items():
        d44s[arch] = d44 = cell44[f"decode44:{arch}"]
        d44["coll_vs_repro"] = coll = \
            d44["collective_bytes"] / c["repro_coll"]
        limit = c.get("coll_ratio", TRAIN44_COLL_RATIO)
        log(f"phase 16: {arch} decode step on a {DECODE44_SHAPE['mesh']} "
            f"fake mesh: collective bytes {d44['collective_bytes']:.0f} "
            f"({coll:.3f}x repro's {c['repro_coll']}) "
            f"{json.dumps(d44['collectives'])}")
        require(not d44["whole_vocab_ops"],
                f"phase 16: the {arch} decode cell makes the whole "
                f"vocabulary in {d44['whole_vocab_ops']}")
        require(coll <= limit,
                f"phase 16: the {arch} decode cell's collective bytes are "
                f"{coll:.3f}x repro's (limit {limit})")

    if rates is not None:
        log(f"phase 16: bf16 matmul {rates['matmul_flops_per_s'] / 1e12:.1f}"
            f" TFLOP/s against {roofline.PEAK_FLOPS / 1e12:.0f}; copy "
            f"{rates['copy_bytes_per_s'] / 1e9:.1f} GB/s against "
            f"{roofline.HBM_BW / 1e9:.0f}")
        require(rates["matmul_flops_per_s"] <= 1.05 * roofline.PEAK_FLOPS,
                "phase 16: the matmul reads over 105% of the peak: its "
                "timing is wrong")
        require(rates["copy_bytes_per_s"] <= 1.05 * roofline.HBM_BW,
                "phase 16: the copy reads over 105% of the HBM rate: its "
                "timing is wrong")
    return {"cells": checks, "roofline": rows, "phase15": {
        "step_s": phase15_step_s, "per_rank_bound_s": per_rank,
        "bound_x4_s": 4 * per_rank, "row": p15_row},
        "train44": t44s, "decode44": d44s,
        "rates": rates, "constants": {
            "peak_flops": roofline.PEAK_FLOPS, "hbm_bw": roofline.HBM_BW,
            "link_bw": roofline.LINK_BW, "hbm_gib": roofline.HBM_GIB},
        "dryrun_s": dryrun_s, "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# Phase 17: the port's four examples
# ---------------------------------------------------------------------------

# each example at its own defaults (the sizes of the ``repro`` example it
# ports), run on the card in a subprocess of its own, all four at once
EXAMPLES17 = {
    "quickstart": ("examples/quickstart_torch.py", []),
    "distributed_search": ("examples/distributed_search_torch.py", []),
    "rag_serve": ("examples/rag_serve_torch.py", []),
    "train_lm": ("examples/train_lm_torch.py", []),
}
EXAMPLES17_TIMEOUT_S = 300
# runs an example as ``__main__`` with the launch counts at 0, then prints
# its counts and the modules of the JAX package it loaded (none allowed)
EXAMPLE_RUN = """
import json, runpy, sys
sys.path.insert(0, "src")
import repro_torch.kernels as K
sys.argv = sys.argv[1:]
K.reset_launch_counts()
runpy.run_path(sys.argv[0], run_name="__main__")
print("LAUNCHES", json.dumps(K.launch_counts()))
print("LOADED", json.dumps(sorted(m for m in sys.modules
                                  if m.split(".")[0] in ("repro", "jax"))))
"""


def _example_checks(name: str, res: dict) -> None:
    """Each example's printed result, held: GATE's recall at least the
    medoid's at every beam; the distributed merge the same bits as its
    single-process composition on every rank; the RAG batch retrieved k
    distinct rows a request and generated every token with finite logits;
    the training run survived its crash and its loss fell."""
    if name == "quickstart":
        for bw, g, b in zip(res["beams"], res["gate_recall"],
                            res["nsg_recall"]):
            require(g >= b, f"phase 17: quickstart at beam {bw}: GATE "
                    f"recall@10 {g:.4f} under the medoid's {b:.4f}")
    elif name == "distributed_search":
        require(res["ranks_agree"] and res["equal_single_process"],
                "phase 17: the distributed search differs from its "
                "single-process composition")
    elif name == "rag_serve":
        require(res["logits_finite"] and all(
            len(set(r)) == res["k"] for r in res["retrieved"])
            and all(len(t) == res["steps"] for t in res["tokens"]),
            "phase 17: the RAG example's retrieval or generation is off")
    elif name == "train_lm":
        require(res["restarts"] == 1 and res["final_step"] == res["steps"],
                f"phase 17: training ended at {res['final_step']} after "
                f"{res['restarts']} restarts")
        require(res["losses"][-1] < res["losses"][0],
                "phase 17: the training loss did not fall")


def examples_phase(dev, examples=EXAMPLES17) -> dict:
    """Phase 17: the port's four ``examples/*_torch.py`` as subprocesses
    on the card, all at once: each exits 0, loads no module of the JAX
    package and prints a result ``_example_checks`` holds.  Returns each
    result, the kernel launches each made (summed in ``launches``) and the
    phase's wall seconds."""
    t0 = time.perf_counter()
    env = _dryrun_env()
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", EXAMPLE_RUN, path, "--device", dev.type,
         *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=ROOT) for name, (path, argv) in examples.items()}
    out, launches = {}, {}
    try:
        deadline = time.monotonic() + EXAMPLES17_TIMEOUT_S
        for name, p in procs.items():
            so, se = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
            require(p.returncode == 0,
                    f"phase 17: {name} exited {p.returncode}:\n"
                    f"{so[-3000:]}\n{se[-3000:]}")
            lines = so.splitlines()

            def tagged(tag):
                return json.loads([ln for ln in lines
                                   if ln.startswith(tag + " ")][-1]
                                  [len(tag) + 1:])
            require(tagged("LOADED") == [],
                    f"phase 17: {name} loaded {tagged('LOADED')}")
            res = tagged("RESULT")
            _example_checks(name, res)
            counts = tagged("LAUNCHES")
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            out[name] = {"result": res, "launches": counts}
            log(f"phase 17: {name}: " + json.dumps(
                {k: v for k, v in res.items()
                 if k not in ("tokens", "retrieved", "losses")}))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"examples": out, "launches": launches,
            "seconds": time.perf_counter() - t0}


# phase 18: benchmarks/bench_ood.py's workload (the paper's Fig. 6) at a
# real size: laion3m-like at its own width, GATE trained on a 50/50 log of
# in-distribution and OOD historical queries, searched per query type
OOD_PROFILE = "laion3m-like"
OOD_ROWS = 100_000      # 250,000 took the smoke past 900 s (PERF.md §4)
OOD_TRAIN = 10_000      # the training half of train_eval_query_split
OOD_EVAL = 5_000        # evaluation queries of each type
OOD_BEAMS = (8, 16, 32, 64, 128)  # 64 is required: the kernels' beam
OOD_NSG = {"R": 32, "knn_k": 32, "search_l": 64, "pool_size": 96}
# the hop kernels at the other widths of the paper's Table 2, on
# databases of WIDTH_ROWS rows, at (1024, WIDTH_R) ids
WIDTH_PROFILES = ("text2image10m-like", "tiny5m-like", "gist1m-like")
WIDTH_ROWS = 50_000
WIDTH_R = 247


def ood_sweep(torch, idx, q, gt, beams, dev) -> dict:
    """``measure_entry_strategy`` (benchmarks/common.py) of GATE's and the
    medoid's entries over ``beams`` (max_hops = max(4·beam, 64), ``fused``,
    l2), then ``xla`` and ``fused_q8`` at beam 64 beside the sweep's
    ``fused`` row.  Gates: GATE at least the medoid - 0.02 at every beam,
    ``fused`` ids on at least 0.999 of ``xla``'s and ``fused_q8`` at least
    ``fused`` - 0.005 at beam 64."""
    from repro_torch import SearchParams

    qd = torch.as_tensor(q, device=dev)
    sweep = {"GATE": [], "medoid": []}
    ids64 = {}
    for bw in beams:
        sp = SearchParams(k=10, beam_width=bw, max_hops=max(4 * bw, 64),
                          kernel="fused", rerank_mult=4)
        for name, entry in (("GATE", "gate"), ("medoid", "medoid")):
            row = timed_search(torch, idx, qd, gt, sp, entry, dev)
            ids = row.pop("ids")
            if bw == 64 and name == "GATE":
                ids64["fused"] = ids
            sweep[name].append({"beam_width": bw, **row})
        g, m = sweep["GATE"][-1], sweep["medoid"][-1]
        require(g["recall_at_10"] >= m["recall_at_10"] - 0.02,
                f"phase 18: GATE recall@10 {g['recall_at_10']:.4f} below the "
                f"medoid's {m['recall_at_10']:.4f} - 0.02 at beam {bw}")
    kernels = {"fused": next(r for r in sweep["GATE"] if r["beam_width"] == 64)}
    sp = SearchParams(k=10, beam_width=64, max_hops=256, rerank_mult=4)
    for kern in ("xla", "fused_q8"):
        kernels[kern] = timed_search(torch, idx, qd, gt,
                                     sp.replace(kernel=kern), "gate", dev)
        ids64[kern] = kernels[kern].pop("ids")
    agree = agreement(ids64["fused"], ids64["xla"])
    r = {k: v["recall_at_10"] for k, v in kernels.items()}
    require(agree >= 0.999,
            f"phase 18: fused ids agree with xla on {agree:.5f} < 0.999")
    require(r["fused_q8"] >= r["fused"] - 0.005,
            "phase 18: fused_q8 recall@10 below fused - 0.005")
    return {"sweep": sweep, "kernels_at_64": kernels, "fused_vs_xla": agree}


def width_records(torch, np, dev, rows=WIDTH_ROWS, R=WIDTH_R,
                  reps: int = 30) -> dict:
    """K1 and K2 against their plain versions (max abs error 0.0) at (1024,
    ``R``) ids into a ``rows``-row database of each profile, l2 and cosine,
    each time beside its bound and the ring's rows (``hop_kernel_records``;
    the queries are in-distribution, seed 17), for ``WIDTH_PROFILES``."""
    from repro_torch.data.synthetic import make_database, make_queries_in_dist

    out = {}
    for profile in WIDTH_PROFILES:
        db, _ = make_database(profile, rows, seed=0)
        q = make_queries_in_dist(db, 1024, seed=17)
        rec = hop_kernel_records(torch, np, db, q, dev, R,
                                 np.random.default_rng(11), reps)
        for name, by_metric in rec.items():
            for metric, m in by_metric.items():
                require(m["max_abs_err"] == 0.0,
                        f"phase 18: {name} at d = {db.shape[1]} ({metric}) "
                        f"is {m['max_abs_err']:.3g} off its plain version")
        out[profile] = {"d": int(db.shape[1]), "rows": rows,
                        "shape": [len(q), R], **rec}
        log(f"phase 18: hop kernels at d = {db.shape[1]}: " + json.dumps(rec))
    return out


def ood_phase(torch, np, dev, n: int = OOD_ROWS, n_train: int = OOD_TRAIN,
              n_eval: int = OOD_EVAL, gcfg=None, nsg_kw=None,
              beams=OOD_BEAMS, width_kw=None, check_every: int = 10,
              n_plain: int = 5) -> dict:
    """Phase 18: GATE on bench_ood's workload.  ``n`` rows of laion3m-like
    (d = 512, seed 0); the training half of ``train_eval_query_split(db,
    n_train, n_train // 10, seed=1, ood_fraction=0.5)`` as the log;
    ``n_eval`` in-distribution and ``n_eval`` OOD evaluation queries (seed
    17, as bench_ood draws them); ``beams`` must hold 64.
    ``GateIndex.build`` with ``gcfg`` (default ``GateConfig()``) and phase
    4's NSG settings: the loss must fall and every hub have a positive.  Each query type against exact
    ground truth (``ood_sweep``); GATE's in/out recall gap at beam 64,
    reported, not gated.  The kernel launches of the build and the
    searches are this phase's counts.  Then every K1 / K2 call of one
    ``fused`` and one ``fused_q8`` search of the OOD queries is recorded,
    replayed and every ``check_every``-th held against the plain version
    (``hop_phase``; max abs error 0.0), and the hop kernels are held and
    timed at the other widths (``width_records(**width_kw)``)."""
    from repro_torch import GateConfig, GateIndex, exact_knn
    from repro_torch import kernels as K
    from repro_torch.data.synthetic import (
        make_database, make_queries_in_dist, make_queries_ood,
        train_eval_query_split,
    )

    t_phase = time.perf_counter()
    db, _ = make_database(OOD_PROFILE, n, seed=0)
    train_q, _ = train_eval_query_split(db, n_train, n_train // 10, seed=1,
                                        ood_fraction=0.5)
    queries = {"in_dist": make_queries_in_dist(db, n_eval, seed=17),
               "ood": make_queries_ood(db, n_eval, seed=17)}
    out = {"profile": OOD_PROFILE, "n": n, "d": int(db.shape[1]),
           "train_queries": len(train_q), "eval_queries": n_eval,
           "data_s": time.perf_counter() - t_phase}
    log(f"phase 18: data {db.shape}, {len(train_q)} training queries "
        f"(50/50 in/out), {n_eval} + {n_eval} evaluation queries, "
        f"{out['data_s']:.2f} s")

    K.reset_launch_counts()
    t0 = time.perf_counter()
    idx = GateIndex.build(db, train_q, gcfg or GateConfig(), device=dev,
                          **(nsg_kw or OOD_NSG))
    rep = idx.build_report
    out["build"] = {
        "seconds": time.perf_counter() - t0,
        "stages": {k: v for k, v in rep.items()
                   if k.startswith(("t_", "nsg_t_"))},
        "repaired_nodes": rep.get("nsg_repair_nodes"),
        "repair_waves": rep.get("nsg_repair_waves"),
        "padded_R": int(idx.neighbors.shape[1]),
        "loss_first": rep["loss_first"], "loss_last": rep["loss_last"],
        "samples": rep["samples"],
    }
    log("phase 18: build " + json.dumps(out["build"]))
    require(rep["loss_last"] < rep["loss_first"],
            "phase 18: the two-tower loss did not fall")
    require(rep["samples"]["hub_with_no_pos"] == 0,
            "phase 18: a hub has no positive query")
    idx.ensure_quantized()
    out["memory_bytes"] = idx.memory_bytes()
    log("phase 18: memory_bytes " + json.dumps(out["memory_bytes"]))

    out["types"] = {}
    for qtype, q in queries.items():
        t0 = time.perf_counter()
        gt, _ = exact_knn(q, db, 10, device=dev)
        rec = ood_sweep(torch, idx, q, gt, beams, dev)
        rec["seconds"] = time.perf_counter() - t0
        out["types"][qtype] = rec
        log(f"phase 18: {qtype} " + json.dumps(rec))
    out["launches"] = K.launch_counts()
    log("launches on the OOD path: " + json.dumps(out["launches"]))
    r64 = {t: r["kernels_at_64"]["fused"]["recall_at_10"]
           for t, r in out["types"].items()}
    out["gap_at_64"] = r64["in_dist"] - r64["ood"]
    log(f"phase 18: GATE in/out recall@10 gap at beam 64: "
        f"{out['gap_at_64']:.5f} ({r64})")

    out["hop"] = hop_phase(torch, np, idx, queries["ood"], dev,
                           check_every=check_every, n_plain=n_plain,
                           labels=("fused_l2", "fused_q8_l2"),
                           tag="phase 18: hop")
    for label, h in out["hop"].items():
        require(h["kernel"]["max_abs_err"] == 0.0,
                f"phase 18: {label}'s recorded calls are "
                f"{h['kernel']['max_abs_err']:.3g} off the plain version")
    del idx, db
    gc.collect()
    out["widths"] = width_records(torch, np, dev, **(width_kw or {}))
    out["seconds"] = time.perf_counter() - t_phase
    return out

CSRC = "src/repro_torch/csrc/"
SOURCES = {"gather_rows_dist": CSRC + "gather_dist.cu",
           "gather_rows_dist_q8": CSRC + "gather_dist.cu",
           "twotower_score": CSRC + "twotower_score.cu",
           "topk_min": CSRC + "topk.cu", "l2dist": CSRC + "l2dist.cu",
           "gather_dist": CSRC + "gather_dist.cu",
           "greedy_assign": CSRC + "greedy_assign.cu"}
REPLACES = {"gather_rows_dist": "src/repro/kernels/gather_dist.py:129",
            "gather_rows_dist_q8": "src/repro/kernels/gather_dist.py:205",
            "twotower_score": "src/repro/kernels/twotower_score.py:40",
            "topk_min": "src/repro/kernels/topk.py:40",
            "l2dist": "src/repro/kernels/l2dist.py:49",
            "gather_dist": "src/repro/kernels/gather_dist.py:59",
            # port-only: repro runs this pass as a lax.scan, no Pallas kernel
            "greedy_assign": "none (port-only; repro scans it at "
                             "src/repro/core/hbkm.py:75)"}
SHAPE_KEYS = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "max_abs_err", "baseline_ms", "baseline_max_abs_err", "plan",
              "ms_net", "baseline_ms_net", "read_ms")


def _at_shape(rec: dict) -> dict:
    return {k: rec[k] for k in SHAPE_KEYS if k in rec}


def kernels_line(kres, api, hop, launches, serve_launches,
                 feedback_launches, single, greedy, ablation_launches=None,
                 rag_launches=None, moe_rag_launches=None,
                 recurrent_rag_launches=None, example_launches=None,
                 ood=None) -> list:
    """One entry per kernel for the line before the last: K1 and K2 at the
    10,000-query search's own calls (hop phase) with their fixed (1024, 32)
    rows beside them, and K1 at the single-query search's (1, R) calls
    (``single``); K3 at the search's shape with the serve request's beside
    it; K4 and K5 at bench_kernels.py's shapes with the composed top-10's
    beside them; K6 at bench_kernels.py's; ``greedy_assign`` (port-only)
    at its 20,000-row slice with the 1M root split beside it (``greedy``).
    K1-K3 count their launches on the search, serve, feedback, ablation
    and the three RAG paths, ``greedy_assign`` on the ablation path; every
    kernel adds its launches in phase 17's examples (``example_launches``,
    where given).  With ``ood`` (phase 18's record), K1-K3 add that
    phase's launches, and K1 and K2 carry its recorded OOD searches'
    calls (``ood_shape``) and the other widths' (1024, 247) rows
    (``widths``), their errors in ``max_abs_err``."""
    extra = {"ablations": ablation_launches or {}, "rag": rag_launches or {},
             "rag_moe": moe_rag_launches or {},
             "rag_recurrent": recurrent_rag_launches or {},
             "ood": ood["launches"] if ood else {}}
    hop_of = {"gather_rows_dist": "fused_l2", "gather_rows_dist_q8": "fused_q8_l2"}
    comp = api["composed_top10"]
    line = []
    for name in SOURCES:
        if name in hop_of:  # K1, K2: the search and serve paths
            h = hop[hop_of[name]]
            fixed = kres[name]
            main_rec = {"ms": h["kernel"]["ms_median"],
                        "plain_ms": h["plain_ms_median"],
                        "bound_ms": h["bound_ms_median"],
                        "bound_by": h["bound_by"]}
            err = max([h["kernel"]["max_abs_err"]]
                      + [v["max_abs_err"] for v in fixed.values()])
            if name == "gather_rows_dist":
                err = max(err, single["max_abs_err"])
            by_path = {"search": launches[name], "serve": serve_launches[name],
                       "feedback": feedback_launches[name]}
        elif name in kres:  # K3: the search, serve and feedback paths
            main_rec = kres[name]["search"]
            err = max(v["max_abs_err"] for v in kres[name].values())
            by_path = {"search": launches[name], "serve": serve_launches[name],
                       "feedback": feedback_launches[name]}
        elif name == "greedy_assign":  # port-only: greedy HBKM
            main_rec = greedy["slice"]
            err = main_rec["max_abs_err"]
            by_path = {"ablations": extra["ablations"].get(name, 0)}
        else:             # K4-K6: the kernel API path
            main_rec = api[name]
            err = main_rec["max_abs_err"]
            by_path = {"api": api["launches"][name]}
        if name in ("gather_rows_dist", "gather_rows_dist_q8", "twotower_score"):
            for path, counts in extra.items():
                if counts:
                    by_path[path] = counts.get(name, 0)
        if example_launches is not None:
            by_path["examples"] = example_launches.get(name, 0)
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": err,
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
            "library_ms": main_rec.get("library_ms"),
        }
        if name in hop_of:
            entry["library_note"] = "no single PyTorch call gathers rows and scores them"
            entry["shape"] = [h["B"], h["R"]]
            entry["ms_per_search"] = h["kernel"]["ms_sum"]
            entry["fixed_shape_1024x32"] = {
                m: {k: fixed[m][k] for k in ("ms", "plain_ms", "bound_ms")}
                for m in ("l2", "cosine")}
            if name == "gather_rows_dist":
                entry["single_query_shape"] = {
                    k: single[k] for k in ("shape", "ms", "plain_ms",
                                           "bound_ms", "bound_by")}
            if ood:
                oh = ood["hop"][hop_of[name]]
                entry["ood_shape"] = {
                    "d": ood["d"], "shape": [oh["B"], oh["R"]],
                    "ms": oh["kernel"]["ms_median"],
                    "ms_per_search": oh["kernel"]["ms_sum"],
                    "plain_ms": oh["plain_ms_median"],
                    "bound_ms": oh["bound_ms_median"],
                    "bound_by": oh["bound_by"]}
                entry["widths"] = {
                    str(w["d"]): {m: {k: w[name][m][k] for k in
                                      ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "ring_rows")}
                                  for m in ("l2", "cosine")}
                    for w in ood["widths"].values()}
                entry["max_abs_err"] = max(
                    [err, oh["kernel"]["max_abs_err"]]
                    + [w[name][m]["max_abs_err"] for w in ood["widths"].values()
                       for m in ("l2", "cosine")])
            line.append(entry)
            continue
        entry.update(_at_shape(main_rec))
        entry["max_abs_err"] = err
        if name == "twotower_score":
            entry["library_call"] = "torch.nn.functional.cosine_similarity"
            entry["serve_shape"] = _at_shape(kres[name]["serve"])
        elif name == "greedy_assign":
            entry["library_call"] = None
            entry["library_note"] = ("no PyTorch call assigns rows one after "
                                     "another against running counts")
            entry["root_split_shape"] = _at_shape(greedy["root_split"])
        else:
            entry["library_call"] = main_rec["library_call"]
        if name in ("l2dist", "topk_min"):
            entry["composed_shape"] = _at_shape(comp[name])
        line.append(entry)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="database rows")
    ap.add_argument("--queries", type=int, default=10_000,
                    help="training queries and evaluation queries, each")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the full record to this JSON file")
    ap.add_argument("--hop-baseline", type=Path, default=None,
                    help="another gather_dist.cu (e.g. the parent commit's): "
                         "its hop kernels are timed and held on the same "
                         "recorded calls as the port's")
    ap.add_argument("--kernel-baseline", type=Path, default=None,
                    help="a directory with another twotower_score.cu, "
                         "topk.cu, l2dist.cu and gather_dist.cu (e.g. the "
                         "parent commit's csrc): K3-K6 of both are timed on "
                         "the same inputs and must give the same bits, and "
                         "the fused search is run again on the baseline K3 "
                         "and must return the same ids; a gather_dist.cu "
                         "also named by --hop-baseline is built once")
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

    from repro_torch import GateConfig, GateIndex, SearchParams, exact_knn
    from repro_torch import kernels as K
    from repro_torch.data.synthetic import (
        make_database, make_queries_in_dist, train_eval_query_split,
    )
    from repro_torch.kernels import _build

    # 1. build every kernel
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
        + json.dumps({k: round(v, 2) for k, v in secs.items()}))
    for name, text in _build.build_logs.items():
        log_ptxas(name, text)
    # other sources to time beside the port's, each built once
    kernel_srcs = {}
    if args.kernel_baseline is not None:
        kernel_srcs = {stem: args.kernel_baseline / f"{stem}.cu"
                       for stem in ("twotower_score", "topk", "l2dist",
                                    "gather_dist")}
    hop_srcs = [args.hop_baseline] if args.hop_baseline is not None else []
    libs = load_baselines([*kernel_srcs.values(), *hop_srcs])
    kbase = ({stem: libs[p.resolve()] for stem, p in kernel_srcs.items()}
             if kernel_srcs else None)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    # the least a kernel reads under cuda_ms: an empty spin kernel's time
    floor_ms = cuda_ms(torch, lambda i: torch.cuda._sleep(0))
    log(f"timing floor (empty kernel, median of 30): {floor_ms * 1e3:.2f} us")

    # data
    t0 = time.perf_counter()
    db, _ = make_database("sift10m-like", args.n, seed=0)
    train_q, eval_q = train_eval_query_split(db, args.queries, args.queries)
    log(f"data: db {db.shape} train {train_q.shape} eval {eval_q.shape} "
        f"{time.perf_counter() - t0:.2f} s")

    # 2. kernel phase
    kres = kernel_phase(torch, np, db, eval_q, dev, n_sm=n_sm, baseline=kbase)
    for name, rec in kres.items():
        log(f"kernel {name}: " + json.dumps(rec))

    # 3. the kernel API path
    api = api_phase(torch, np, db, eval_q, dev, baseline=kbase)
    for rec in (api["topk_min"], api["composed_top10"]["topk_min"],
                api["gather_dist"]):
        net_of_floor(rec, floor_ms)
    for name, rec in api.items():
        log(f"api {name}: " + json.dumps(rec))
    for label, rec in (("K4", api["topk_min"]),
                       ("K4", api["composed_top10"]["topk_min"]),
                       ("K6", api["gather_dist"])):
        log(f"{label} {rec['shape']} net of the {floor_ms * 1e3:.2f} us floor: "
            + json.dumps({key: rec[key] for key in
                          ("ms", "ms_net", "baseline_ms", "baseline_ms_net")
                          if key in rec}))
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
    prof_q8 = profile_search(
        torch, idx, eval_q, dev, l2["gate/fused_q8"]["seconds"],
        SearchParams(k=10, beam_width=64, max_hops=256, kernel="fused_q8",
                     rerank_mult=4))
    log("profile gate/fused_q8 l2: " + json.dumps(prof_q8))

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

    on_base = None
    if kbase is not None:
        on_base = search_on_baseline_k3(torch, idx, eval_q, dev,
                                        kbase["twotower_score"])
        log("search on the baseline K3: " + json.dumps(on_base))

    # 7b. the hop kernels at the calls the searches above really make
    hop = hop_phase(torch, np, idx, eval_q, dev,
                    libs[args.hop_baseline.resolve()] if hop_srcs else None)

    # 8. the serve path; its own counts (the two daemons' runs)
    serve = serve_phase(torch, np, idx, eval_q, dev)
    serve_launches = serve["launches"]
    log("launches on the serve path: " + json.dumps(serve_launches))
    for name in ("gather_rows_dist", "twotower_score"):
        require(serve_launches[name] > 0,
                f"kernel {name} was not launched on the serve path")

    # 9. the feedback loop and index persistence; its own counts.  The
    # learned daemon serves queries phase 8 did not: fresh ones from the
    # eval queries' process (train_eval_query_split's eval seed is 4)
    fresh_q = make_queries_in_dist(db, 16 * 1024, seed=104)
    K.reset_launch_counts()
    fb = feedback_phase(torch, np, idx, eval_q, fresh_q, dev,
                        serve["routed"]["qlog_path"], serve["routed"])
    fb_launches = K.launch_counts()
    log("launches on the feedback path: " + json.dumps(fb_launches))
    for name in ("gather_rows_dist", "gather_rows_dist_q8", "twotower_score"):
        require(fb_launches[name] > 0,
                f"kernel {name} was not launched on the feedback path")
    single = single_query_k1(torch, np, fb.pop("single_calls"), dev)
    log("K1 at the single-query shape: " + json.dumps(single))
    log(f"phase 9: {fb['seconds']:.1f} s")

    # the bfs build's hop_counts at 1M, timed in a process of its own while
    # phases 10-11 run (the pool is stopped however they end)
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        bfs_job, bfs_targets = start_bfs_timing(torch, np, pool, idx, train_q,
                                                dev)

        # 10. the build's ablation paths and the entry baselines on phase
        # 4's graph; its own counts, then greedy_assign held against its
        # plain version
        K.reset_launch_counts()
        abl = ablation_phase(torch, np, idx, db, train_q, eval_q, gt, l2, dev)
        abl_launches = K.launch_counts()
        log("launches on the ablation path: " + json.dumps(abl_launches))
        for name in ("gather_rows_dist", "twotower_score", "greedy_assign"):
            require(abl_launches[name] > 0,
                    f"kernel {name} was not launched on the ablation path")
        greedy = greedy_record(torch, np, db, dev)
        log("greedy_assign: " + json.dumps(greedy))
        log(f"phase 10: {abl['seconds']:.1f} s")

        # 11. retrieval-augmented serving with gemma-2b at full width; its
        # own counts, then each request held against a plain search at its
        # rung
        K.reset_launch_counts()
        rag = rag_phase(torch, np, idx, eval_q, dev, n_req=RAG_REQUESTS)
        rag_launches = K.launch_counts()
        log("launches on the RAG path: " + json.dumps(rag_launches))
        for name in ("gather_rows_dist", "twotower_score"):
            require(rag_launches[name] > 0,
                    f"kernel {name} was not launched on the RAG path")
        rag["requests_checked"] = check_rag(torch, np, idx, rag.pop("check"),
                                            dev)
        log(f"phase 11: {rag['seconds']:.1f} s, {rag['requests_checked']} "
            "requests' ids equal a plain search at their rung")

        # 12. retrieval-augmented serving with the MoE decoder at full
        # width and depth, after phase 11's model is freed; its own counts
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log(f"memory before phase 12: {torch.cuda.memory_allocated()} bytes")
        K.reset_launch_counts()
        # 2 requests, not 8: the smoke's 900 s with phases 15-18 (PERF.md §4)
        moe_rag = moe_rag_phase(torch, np, idx, eval_q, dev, n_req=2)
        moe_rag_launches = K.launch_counts()
        log("launches on the MoE RAG path: " + json.dumps(moe_rag_launches))
        for name in ("gather_rows_dist", "twotower_score"):
            require(moe_rag_launches[name] > 0,
                    f"kernel {name} was not launched on the MoE RAG path")
        moe_rag["requests_checked"] = check_rag(torch, np, idx,
                                                moe_rag.pop("check"), dev)
        moe_rag["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"phase 12: {moe_rag['seconds']:.1f} s, "
            f"{moe_rag['requests_checked']} requests' ids equal a plain "
            "search at their rung")

        # 13. retrieval-augmented serving with the recurrent families at
        # full width and depth, after phase 12's model is freed; its own
        # counts
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log(f"memory before phase 13: {torch.cuda.memory_allocated()} bytes")
        K.reset_launch_counts()
        rec_rag = recurrent_rag_phase(torch, np, idx, eval_q, dev, n_req=2)
        rec_rag_launches = K.launch_counts()
        log("launches on the recurrent RAG path: "
            + json.dumps(rec_rag_launches))
        for name in ("gather_rows_dist", "twotower_score"):
            require(rec_rag_launches[name] > 0,
                    f"kernel {name} was not launched on the recurrent RAG "
                    "path")
        rec_rag["requests_checked"] = sum(
            check_rag(torch, np, idx, c, dev) for c in rec_rag.pop("check"))
        rec_rag["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        log(f"phase 13: {rec_rag['seconds']:.1f} s, "
            f"{rec_rag['requests_checked']} requests' ids equal a plain "
            "search at their rung")
        t0 = time.perf_counter()
        abl["bfs"]["projection_full_size"] = bfs_projection(
            bfs_job.get(timeout=600), bfs_targets)
        log(f"bfs at N={args.n}, hop_counts projected (waited "
            f"{time.perf_counter() - t0:.1f} s): "
            + json.dumps(abl["bfs"]["projection_full_size"]))

    # 14. the enc-dec family and the training path at full width, after
    # phase 13's models are freed; its own counts, which no kernel needs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"memory before phase 14: {torch.cuda.memory_allocated()} bytes")
    K.reset_launch_counts()
    train = train_phase(torch, np, dev)
    train_launches = K.launch_counts()
    log("launches on the training path (none required): "
        + json.dumps(train_launches))
    log(f"phase 14: {train['seconds']:.1f} s")

    # 15. the partitioned index on 4 ranks sharing the card, after phase
    # 14's models are freed; its own counts (this process's), which no
    # kernel needs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"memory before phase 15: {torch.cuda.memory_allocated()} bytes")
    K.reset_launch_counts()
    part = partition_phase(
        torch, np, db, (idx.tower_cfg, idx.tower_params.as_dict()),
        (idx.hubs.ids, idx.nav.reps), eval_q, gt, dev)
    part_launches = K.launch_counts()
    log("launches on the partitioned path (none required): "
        + json.dumps(part_launches))
    log("phase 15: " + json.dumps(part))
    log(f"phase 15: {part['seconds']:.1f} s")

    # 16. the dry-run tooling: production cells on a fake 256-rank mesh,
    # phase 15's step priced, the card's rates; its own counts, which no
    # kernel needs
    K.reset_launch_counts()
    dry = dryrun_phase(torch, np, dev,
                       max(statistics.median(r) for r in part["step_s"]))
    dry_launches = K.launch_counts()
    log("launches on the dry-run path (none required): "
        + json.dumps(dry_launches))
    log(f"phase 16: {dry['seconds']:.1f} s")

    # 17. the port's four examples on the card, as subprocesses; their
    # launches are counted in each subprocess and added to the line
    gc.collect()
    torch.cuda.empty_cache()
    ex = examples_phase(dev)
    log("launches in the examples: " + json.dumps(ex["launches"]))
    log(f"phase 17: {ex['seconds']:.1f} s")

    # 18. bench_ood's workload at a real size and the hop kernels at every
    # Table-2 width, after phase 4's index and database are freed; its own
    # counts (the build and the searches)
    memory_bytes = idx.memory_bytes()
    del idx, db, train_q
    gc.collect()
    torch.cuda.empty_cache()
    log(f"memory before phase 18: {torch.cuda.memory_allocated()} bytes")
    ood = ood_phase(torch, np, dev)
    for name in ("gather_rows_dist", "gather_rows_dist_q8", "twotower_score"):
        require(ood["launches"][name] > 0,
                f"kernel {name} was not launched on the OOD path")
    log(f"phase 18: {ood['seconds']:.1f} s")

    line = kernels_line(kres, api, hop, launches, serve_launches,
                        fb_launches, single, greedy, abl_launches,
                        rag_launches, moe_rag_launches, rec_rag_launches,
                        ex["launches"], ood)
    record = {
        "card": smi, "n": args.n, "queries": args.queries,
        "timing_floor_ms": floor_ms,
        "kernel_build_s": secs, "kernels": kres, "build_s": t_build,
        "build_report": rep, "memory_bytes": memory_bytes,
        "search_l2": {k: {kk: vv for kk, vv in v.items() if kk != "ids"}
                      for k, v in l2.items()},
        "search_cosine": {k: {kk: vv for kk, vv in v.items() if kk != "ids"}
                          for k, v in cos.items()},
        "agreement": {"l2": agree_l2, "cosine": agree_cos},
        "launches": launches, "profile_fused_l2": prof,
        "profile_fused_q8_l2": prof_q8, "hop": hop, "api": api,
        "serve": serve, "search_on_baseline_k3": on_base,
        "feedback": fb, "feedback_launches": fb_launches,
        "k1_single_query": single,
        "ablations": abl, "ablation_launches": abl_launches,
        "greedy_assign": greedy, "rag": rag, "rag_launches": rag_launches,
        "moe_rag": moe_rag, "moe_rag_launches": moe_rag_launches,
        "recurrent_rag": rec_rag, "recurrent_rag_launches": rec_rag_launches,
        "train": train, "train_launches": train_launches,
        "partitioned": part, "partitioned_launches": part_launches,
        "dryrun": dry, "dryrun_launches": dry_launches,
        "examples": ex, "ood": ood,
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
