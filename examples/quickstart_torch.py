"""Quickstart on the PyTorch port: build a GATE index over a clustered
vector DB and search it.

    PYTHONPATH=src python examples/quickstart_torch.py              # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Builds NSG → GATE (hubs, topology features, two-tower, nav graph), then
compares GATE entry selection against the NSG medoid baseline at the same
search budget: the paper's headline effect (shorter paths, higher recall).
The sizes default to ``examples/quickstart.py``'s; ``--n``, ``--hubs``,
``--epochs`` and the query counts cut them.  The last line is ``RESULT``
and the figures as JSON.
"""
import argparse
import json
import time

import numpy as np

from repro_torch.core import GateConfig, GateIndex
from repro_torch.data.synthetic import make_database, train_eval_query_split
from repro_torch.graphs.knn import exact_knn, recall_at_k
from repro_torch.graphs.nsg import build_nsg
from repro_torch.graphs.params import SearchParams


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=6000)
    ap.add_argument("--train-queries", type=int, default=512)
    ap.add_argument("--eval-queries", type=int, default=128)
    ap.add_argument("--hubs", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--beams", default="16,32,64")
    ap.add_argument("--device", default="cuda",
                    help="where the index is built and searched")
    args = ap.parse_args(argv)
    dev = args.device

    print(f"1) synthetic clustered DB (sift-like profile, {args.n} x 128) ...")
    db, _ = make_database("sift10m-like", args.n, seed=0)
    train_q, eval_q = train_eval_query_split(db, args.train_queries,
                                             args.eval_queries)

    print("2) underlying proximity graph (NSG) ...")
    t0 = time.time()
    nsg = build_nsg(db, R=32, knn_k=32, search_l=64, pool_size=96,
                    device=dev)
    print(f"   built in {time.time() - t0:.1f}s; degree {nsg.degree_stats()}")

    print("3) GATE: hubs -> topology -> query samples -> two-tower ...")
    t0 = time.time()
    index = GateIndex.from_graph(
        db, nsg.neighbors, nsg.enter_id, train_q,
        GateConfig(n_hubs=args.hubs, epochs=args.epochs,
                   batch_hubs=args.hubs),
        device=dev,
    )
    rep = index.build_report
    print(f"   built in {time.time() - t0:.1f}s; contrastive loss "
          f"{rep['loss_first']:.2f} -> {rep['loss_last']:.2f}")

    print("4) search: GATE entries vs NSG medoid entry, same beam budget")
    true_ids, _ = exact_knn(eval_q, db, 10, device=dev)
    out = {"n": args.n, "beams": [], "gate_recall": [], "nsg_recall": [],
           "gate_hops": [], "nsg_hops": [],
           "loss_first": float(rep["loss_first"]),
           "loss_last": float(rep["loss_last"])}
    for bw in (int(b) for b in args.beams.split(",")):
        sp = SearchParams(k=10, beam_width=bw, max_hops=4 * bw)
        rg = index.search(eval_q, params=sp, device=dev)
        rb = index.search_baseline(eval_q, params=sp, device=dev)
        rec_g = recall_at_k(_np(rg.ids), true_ids, 10)
        rec_b = recall_at_k(_np(rb.ids), true_ids, 10)
        hops_g, hops_b = float(_np(rg.hops).mean()), float(_np(rb.hops).mean())
        print(f"   beam={bw:3d}:  GATE recall@10={rec_g:.3f} "
              f"({hops_g:5.1f} hops)   NSG recall@10={rec_b:.3f} "
              f"({hops_b:5.1f} hops)")
        for key, v in (("beams", bw), ("gate_recall", rec_g),
                       ("nsg_recall", rec_b), ("gate_hops", hops_g),
                       ("nsg_hops", hops_b)):
            out[key].append(v)
    print("RESULT", json.dumps(out))
    return out


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


if __name__ == "__main__":
    main()
