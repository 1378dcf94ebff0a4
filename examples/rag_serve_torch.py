"""End-to-end serving on the PyTorch port: GATE retrieval feeding batched
LM generation (the paper's production seat, RAG).

    PYTHONPATH=src python examples/rag_serve_torch.py [--arch gemma-2b] [--batch 8]
    PYTHONPATH=src python examples/rag_serve_torch.py --device cpu

Pipeline per request batch:
    request embedding → two-tower query tower → entry hub → Algorithm-1
    beam search on NSG → top-k docs → [docs ‖ prompt] → prefill → decode loop.
The LM is the reduced same-family config with random weights drawn from
``--seed``.  The sizes default to ``examples/rag_serve.py``'s; ``--hubs``,
``--epochs`` and ``--history`` cut the index's.  The last line is
``RESULT`` and the figures as JSON.
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.core import GateConfig, GateIndex
from repro_torch.data.synthetic import make_database, make_queries_in_dist
from repro_torch.graphs.knn import exact_knn, recall_at_k
from repro_torch.graphs.nsg import build_nsg
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.retrieval import RagPipeline


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--db-size", type=int, default=4000)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--history", type=int, default=512)
    ap.add_argument("--hubs", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the index is searched and the LM runs")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = get_reduced(args.arch)
    print(f"1) LM: {args.arch} (reduced same-family config)")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    engine = ServeEngine(cfg, params, device=dev)

    print(f"2) vector DB ({args.db_size} x 128) + NSG + GATE index ...")
    db, _ = make_database("sift10m-like", args.db_size, seed=0)
    hist_q = make_queries_in_dist(db, args.history, seed=1)
    nsg = build_nsg(db, R=32, knn_k=32, search_l=64, pool_size=96,
                    device=dev)
    index = GateIndex.from_graph(
        db, nsg.neighbors, nsg.enter_id, hist_q,
        GateConfig(n_hubs=args.hubs, epochs=args.epochs,
                   batch_hubs=args.hubs),
        device=dev,
    )

    rng = np.random.default_rng(0)
    doc_tokens = rng.integers(2, cfg.vocab_size, (args.db_size, 8)).astype(
        np.int32
    )
    pipe = RagPipeline(index, engine, doc_tokens, k=args.k, beam_width=32,
                       device=dev)

    print(f"3) serving {args.batch} batched requests ...")
    queries = make_queries_in_dist(db, args.batch, seed=2)
    prompts = rng.integers(2, cfg.vocab_size, (args.batch, 16)).astype(np.int32)
    t0 = time.time()
    res = pipe(queries, prompts, max_new_tokens=args.new_tokens)
    dt = time.time() - t0
    gen = res.generation
    print(f"   retrieved ids[0] = {res.retrieved_ids[0]}")
    print(f"   generated[0]     = {gen.tokens[0]}")
    print(f"   {args.batch} requests x {gen.steps} new tokens in {dt:.2f}s "
          f"({args.batch * gen.steps / dt:.1f} tok/s)")
    true_ids, _ = exact_knn(queries, db, args.k, device=dev)
    out = {"arch": cfg.name, "batch": args.batch, "db_size": args.db_size,
           "k": args.k, "steps": int(gen.steps),
           "retrieved": np.asarray(res.retrieved_ids).tolist(),
           "retrieval_recall": recall_at_k(np.asarray(res.retrieved_ids),
                                           true_ids, args.k),
           "tokens": np.asarray(gen.tokens).tolist(),
           "logits_finite": bool(np.isfinite(gen.logits_last).all()),
           "seconds": dt, "tokens_per_s": args.batch * gen.steps / dt}
    print("RESULT", json.dumps(out))
    return out


if __name__ == "__main__":
    main()
