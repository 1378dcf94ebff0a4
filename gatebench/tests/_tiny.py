"""A cell of the benchmark cut to a size the CPU runs in seconds, with the
port's plain kernels: the same harness, configuration keys and mix keys."""
import copy
import time

import torch

from gatebench import bench, cells

# recall@10 of a sample at this size lies far below a cell's: 0.45-0.49
# (sift) and 0.24-0.28 (laion) with the towers trained, 0.17-0.22 and
# 0.05-0.08 with them left as drawn
TINY_RECALL = {"sift128-250k": 0.33, "laion512-ood-100k": 0.15}


def tiny_cell(name: str, **mix_over) -> cells.Cell:
    cell = cells.find_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(rows=1500, n_hubs=8, train_queries=200)
    cfg["gate"].update(epochs=4, batch_hubs=8, subgraph_max_nodes=32)
    cfg["nsg"].update(R=12, knn_k=12, search_l=16, pool_size=32)
    cell.config = cfg
    cell.limits = dict(cell.limits,
                       sample_recall={"at_least": TINY_RECALL[cfg["name"]]})
    cell.mix = dict(cell.mix, batch=64, pool=3, check_sample=128, **mix_over)
    return cell


def run_tiny(cell: cells.Cell, seed: int = 2**31 + 7, seconds: float = 0.5,
             **kw) -> dict:
    return bench.run_cell(torch, cell, seed, seconds, False,
                          torch.device("cpu"), time.perf_counter(),
                          log=lambda *a, **k: None, **kw)
