"""Serving entry point: batched generation, optionally RAG through a GATE index.

    python -m repro_torch.launch.serve --arch gemma-2b --reduced --batch 4 --new 16
    python -m repro_torch.launch.serve --arch gemma-2b --reduced --rag \\
        --db-size 4000 --k 4 --kernel fused --metrics-port 9100
    python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --rag \\
        --kernel fused
    python -m repro_torch.launch.serve --arch zamba2-1.2b --rag --kernel fused
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --rag --kernel fused

Everything runs on ``--device`` (default ``cuda``; ``--device cpu`` runs
the kernels' plain versions).  The weights are random, drawn from
``--seed``; where the compute dtype is not the parameter dtype they are
drawn straight into it (every model's ``init_compute``; the hybrid and
RWKV families keep the weights they read in float32), so a model whose
float32 parameters would not fit beside their bf16 copy (qwen2-moe-a2.7b:
67.2 GB and 33.6 GB) holds only the latter.  ``--metrics-port`` exposes
the live metrics registry over HTTP for the run (Prometheus text at
/metrics).  For a long-running queue-driven server use
``python -m repro_torch.serve.daemon`` instead.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.models.model import build_model
from repro_torch.obs import MetricsExporter
from repro_torch.serve.engine import ServeEngine


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--rag", action="store_true")
    ap.add_argument("--route", action="store_true",
                    help="with --rag: per-query hardness routing over the "
                         "ladder (repro_torch.obs.router)")
    ap.add_argument("--db-size", type=int, default=4000)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--kernel", default="xla",
                    choices=("xla", "fused", "fused_q8"),
                    help="with --rag: search distance path — xla = plain "
                         "gather and score, fused = the gather kernel, "
                         "fused_q8 = the int8 codebook kernel + exact rerank")
    ap.add_argument("--qlog", default=None,
                    help="with --rag --route: capture a JSONL query log "
                         "(repro_torch.feedback) for offline replay / fitting")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="expose /metrics on this port for the run "
                         "(0 = ephemeral)")
    ap.add_argument("--hold-metrics", type=float, default=0.0,
                    help="keep the /metrics endpoint up this many seconds "
                         "after the run finishes")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs and the index is built and "
                         "searched")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    exporter = None
    if args.metrics_port is not None:
        exporter = MetricsExporter(port=args.metrics_port)
        port = exporter.start()
        print(f"metrics on http://127.0.0.1:{port}/metrics", flush=True)
    try:
        _run(args)
        if exporter is not None and args.hold_metrics > 0:
            print(f"holding /metrics for {args.hold_metrics:.0f}s", flush=True)
            time.sleep(args.hold_metrics)
    finally:
        if exporter is not None:
            exporter.stop()


def _run(args):
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    device = torch.device(args.device)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = (model.init(gen) if cfg.compute_dtype == cfg.param_dtype
              else model.init_compute(gen))
    engine = ServeEngine(cfg, params, device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(
        2, cfg.vocab_size, (args.batch, args.prompt_len)
    ).astype(np.int32)

    if args.rag:
        from repro_torch.core import GateConfig, GateIndex
        from repro_torch.data.synthetic import make_database, make_queries_in_dist
        from repro_torch.serve.retrieval import RagPipeline

        db, _ = make_database("sift10m-like", args.db_size, seed=args.seed)
        tq = make_queries_in_dist(db, 256, seed=args.seed + 1)
        print("building GATE index ...", flush=True)
        index = GateIndex.build(
            db, tq, GateConfig(n_hubs=32, epochs=30),
            R=16, knn_k=16, search_l=24, pool_size=48, device=device,
        )
        doc_tokens = rng.integers(
            2, cfg.vocab_size, (args.db_size, 8)
        ).astype(np.int32)
        router = None
        if args.route:
            from repro_torch.graphs import SearchParams
            from repro_torch.obs import DEFAULT_LADDER, HardnessRouter

            router = HardnessRouter(DEFAULT_LADDER, batch_size=args.batch)
            print("warming router (rungs x buckets) ...", flush=True)
            index.warmup_router(
                router,
                params=SearchParams(k=args.k, instrument=True,
                                    kernel=args.kernel),
                device=device,
            )
        qlog = None
        if args.qlog:
            if router is None:
                raise SystemExit("--qlog requires --route (the query log "
                                 "captures routed decisions)")
            from repro_torch.feedback import QueryLog

            qlog = QueryLog(args.qlog)
        pipe = RagPipeline(index, engine, doc_tokens, k=args.k,
                           kernel=args.kernel, router=router, qlog=qlog,
                           device=device)
        queries = make_queries_in_dist(db, args.batch, seed=args.seed + 2)
        t0 = time.time()
        res = pipe(queries, prompts, max_new_tokens=args.new,
                   temperature=args.temperature)
        dt = time.time() - t0
        print("retrieved ids[0]:", res.retrieved_ids[0])
        print("generated[0]:", res.generation.tokens[0])
        print(f"{args.batch} requests in {dt:.2f}s")
        if qlog is not None:
            qlog.close()
            print(f"query log: {qlog.written} records -> {qlog.path}")
        return

    t0 = time.time()
    out = engine.generate(
        {"tokens": prompts}, args.new,
        temperature=args.temperature, seed=args.seed,
    )
    dt = time.time() - t0
    print("generated[0]:", out.tokens[0])
    print(
        f"{args.batch} seqs x {out.steps} tokens in {dt:.2f}s "
        f"({args.batch * out.steps / dt:.1f} tok/s)"
    )


if __name__ == "__main__":
    main()
