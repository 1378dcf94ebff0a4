"""Exact k nearest neighbours by brute force, in float64."""
from __future__ import annotations

import numpy as np
import torch


def exact_knn(db: np.ndarray, queries: np.ndarray, k: int, *, device,
              block: int = 1024) -> np.ndarray:
    """(Q, k) int64 ids of each query's ``k`` nearest rows of ``db`` by
    squared L2, nearest first: ``‖q‖² − 2 q·x + ‖x‖²`` in float64 (TF32
    plays no part in a float64 product)."""
    x = torch.as_tensor(db, device=device).to(torch.float64)
    xn = (x * x).sum(dim=1)
    out = np.empty((len(queries), k), np.int64)
    for s in range(0, len(queries), block):
        q = torch.as_tensor(queries[s:s + block], device=device).to(torch.float64)
        d = (q * q).sum(dim=1, keepdim=True) - 2.0 * (q @ x.T) + xn[None, :]
        out[s:s + block] = torch.topk(d, k, dim=1, largest=False,
                                      sorted=True).indices.cpu().numpy()
        del d
    return out


def sq_l2(db: np.ndarray, queries: np.ndarray, ids: np.ndarray, *,
          device) -> np.ndarray:
    """(Q, k) float64 squared L2 distance of each query to the rows ``ids``
    (Q, k) it was answered with; NaN where an id is negative."""
    x = torch.as_tensor(db, device=device)
    q = torch.as_tensor(queries, device=device).to(torch.float64)
    i = torch.as_tensor(ids, device=device).long()
    rows = x[i.clamp_min(0)].to(torch.float64)
    d = ((rows - q[:, None, :]) ** 2).sum(dim=-1)
    return torch.where(i >= 0, d, torch.nan).cpu().numpy()
