"""Distributed GATE search on the PyTorch port: the partitioned index on
``--devices`` gloo ranks.

    PYTHONPATH=src python examples/distributed_search_torch.py [--devices 8]
    PYTHONPATH=src python examples/distributed_search_torch.py --device cpu

Row-shards the DB over a (data, model) mesh of ``(devices // 2, 2)``
ranks, builds a LOCAL subgraph per partition, selects per-shard entries
with the two-tower model, runs the fixed-hop beam search on every shard
and merges the per-shard top-k with one all-gather per mesh dimension
(``repro_torch.core.distributed``).  The ranks are processes of one gloo
group; on the card they share it (one H100 gives NCCL one rank).  The
parent then composes the same shards' searches in one process and checks
that the merged ids and distances are the same bits.  The last line is
``RESULT`` and the figures as JSON.
"""
import argparse
import datetime
import json
import os
import sys
import tempfile
import time

import numpy as np

K = 10


def _knobs(args):
    return dict(beam_width=32, max_hops=64, k=K)


def _inputs(args):
    """The database, the queries, the tower and the hubs, drawn from seeds
    (every rank and the parent draw the same)."""
    import torch

    from repro_torch.core.twotower import (
        TwoTowerConfig, init_params, query_tower,
    )
    from repro_torch.data.synthetic import make_database, make_queries_in_dist

    db, _ = make_database("sift10m-like", args.n, seed=0)
    tcfg = TwoTowerConfig(d_p=db.shape[1])
    params = init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    rng = np.random.default_rng(0)
    hub_ids = rng.choice(args.n, 16 * args.devices, replace=False)
    with torch.no_grad():
        hub_reps = query_tower(params, tcfg, torch.as_tensor(
            db[hub_ids], dtype=torch.float32)).numpy()
    queries = make_queries_in_dist(db, args.queries, seed=5)
    return db, queries, tcfg, params, hub_ids, hub_reps


def _shard(mesh_like, db, tcfg, params, hub_ids, hub_reps, dev):
    from repro_torch.core.distributed import build_sharded_gate
    from repro_torch.graphs.knn import knn_graph

    return build_sharded_gate(
        mesh_like, db, (tcfg, params), hub_reps, hub_ids,
        lambda x, R: knn_graph(x, R, device=dev), R=16)


def rank_main(rank, args, init_file, out_q):
    """One rank: joins the group, builds its shard, runs the search step."""
    try:
        import torch
        import torch.distributed as dist

        from repro_torch.core.distributed import make_search_step
        from repro_torch.launch.mesh import make_host_mesh

        torch.set_num_threads(1)  # the ranks share the host's cores
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=args.devices,
            timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_host_mesh((args.devices // 2, 2), ("data", "model"),
                                  device=args.device)
            db, queries, tcfg, params, hub_ids, hub_reps = _inputs(args)
            sg = _shard(mesh, db, tcfg, params, hub_ids, hub_reps,
                        args.device)
            step = make_search_step(mesh, tcfg, **_knobs(args))
            t0 = time.perf_counter()
            ids, dists, hops = step(sg, queries)
            secs = time.perf_counter() - t0
            out = (rank, True, (ids.cpu().numpy(), dists.cpu().numpy(),
                                float(hops.float().mean()), secs))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent
        import traceback
        out = (rank, False, traceback.format_exc())
    out_q.put(out)


class ShardOf:
    """Partition ``p`` of a mesh of ``shape`` as ``build_sharded_gate``
    reads its mesh: the single-process composition builds every shard."""

    def __init__(self, p, shape, device_type):
        self.p, self.shape, self.device_type = p, tuple(shape), device_type

    def size(self):
        return int(np.prod(self.shape))

    def get_coordinate(self):
        return [int(c) for c in np.unravel_index(self.p, self.shape)]


def single_process(args):
    """Every shard's search composed in this process, then the merge."""
    import torch

    from repro_torch.core.distributed import (
        local_search, merge_top_k, search_knobs,
    )

    db, queries, tcfg, params, hub_ids, hub_reps = _inputs(args)
    shape = (args.devices // 2, 2)
    cand_ids, cand_d = [], []
    for p in range(args.devices):
        sg = _shard(ShardOf(p, shape, args.device), db, tcfg, params,
                    hub_ids, hub_reps, args.device)
        ids, d, _ = local_search(sg, queries, tcfg,
                                 **search_knobs(**_knobs(args)))
        cand_ids.append(ids)
        cand_d.append(d)
    ids, d = merge_top_k(torch.stack(cand_ids), torch.stack(cand_d), K)
    return db, queries, ids.cpu().numpy(), d.cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks (processes) of the mesh, an even number")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="where every rank searches")
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    from repro_torch.graphs.knn import exact_knn, recall_at_k

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    print(f"mesh: data={args.devices // 2}, model=2 over {args.devices} "
          f"gloo ranks on {args.device}")
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=rank_main,
                             args=(r, args, init_file, out_q))
                 for r in range(args.devices)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        results = dict((r, (ok, v)) for r, ok, v in
                       (out_q.get(timeout=600) for _ in procs))
        for p in procs:
            p.join()
        wall = time.perf_counter() - t0
    bad = [v for ok, v in results.values() if not ok]
    if bad:
        raise RuntimeError("a rank failed:\n" + bad[0])
    ids, dists, _, step_s = results[0][1]
    same = all(np.array_equal(v[0], ids) and np.array_equal(v[1], dists)
               for _, v in results.values())
    print("building the shards again in one process ...")
    db, queries, want_ids, want_d = single_process(args)
    equal = bool(np.array_equal(ids, want_ids)
                 and np.array_equal(dists, want_d))
    true_ids, _ = exact_knn(queries, db, K, device=args.device)
    rec = recall_at_k(ids, true_ids, K)
    rec_single = recall_at_k(want_ids, true_ids, K)
    print(f"sharded recall@10 = {rec:.3f} over {args.devices} partitions "
          f"(single process: {rec_single:.3f}; same bits: {equal})")
    print(f"per-query result ids[0] = {ids[0]}")
    out = {"devices": args.devices, "n": args.n, "queries": args.queries,
           "recall": rec, "recall_single_process": rec_single,
           "equal_single_process": equal, "ranks_agree": bool(same),
           "mean_hops_rank0": results[0][1][2], "step_s_rank0": step_s,
           "ranks_wall_s": wall, "ids0": ids[0].tolist()}
    print("RESULT", json.dumps(out))
    if not (equal and same):
        sys.exit("the merged result differs from the single-process one")
    return out


if __name__ == "__main__":
    main()
