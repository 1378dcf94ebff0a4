"""Exact K-nearest-neighbor search (chunked brute force).

‖q−c‖² = ‖q‖² − 2 q·c + ‖c‖² as chunked matrix products.  ``repro`` leaves
this product to XLA outside any Pallas kernel, and the port leaves it to
``torch.matmul`` (full fp32: TF32 is off, see ``repro_torch/__init__``).
Used for index construction and as ground truth.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def pairwise_sq_l2(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(Q,d) x (C,d) -> (Q,C) squared L2, fp32 accumulation."""
    qf = q.to(torch.float32)
    cf = c.to(torch.float32)
    qn = torch.sum(qf * qf, dim=1, keepdim=True)
    cn = torch.sum(cf * cf, dim=1, keepdim=True)
    return torch.clamp_min(qn - 2.0 * (qf @ cf.T) + cn.T, 0.0)


def topk_smallest(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest values per row, ascending, with their indices; among
    equal values the lowest index comes first (``lax.top_k``'s order, which
    ``torch.topk`` does not promise).

    ``torch.topk`` picks freely among values equal to the k-th, so it takes
    k + 1: a row has such a tie across the boundary exactly when its
    (k+1)-th smallest value equals its k-th, and only those rows are redone
    with a stable sort of the whole row; every other row only needs its
    first k picks put in order."""
    kk = min(k + 1, d.shape[1]) if k > 0 else 0
    vals, idx = torch.topk(d, kk, dim=1, largest=False, sorted=True)
    tied = None
    if 0 < k < kk:
        tied = (vals[:, k] == vals[:, k - 1]).nonzero().squeeze(1)
        vals, idx = vals[:, :k], idx[:, :k]
    idx, perm = torch.sort(idx, dim=1)
    vals, perm = torch.sort(vals.gather(1, perm), dim=1, stable=True)
    idx = idx.gather(1, perm)
    if tied is not None and tied.numel():
        s_vals, s_idx = torch.sort(d[tied], dim=1, stable=True)
        vals[tied] = s_vals[:, :k]
        idx[tied] = s_idx[:, :k]
    return vals, idx


def exact_knn(
    queries,
    db,
    k: int,
    *,
    exclude_self: bool = False,
    q_chunk: int = 2048,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k nearest db ids/distances per query; numpy arrays or tensors in,
    numpy ``(ids int32, dists float32)`` out."""
    device = torch.device(device)
    qt = torch.as_tensor(queries, device=device)
    dbt = torch.as_tensor(db, device=device)
    n = qt.shape[0]
    kk = k + (1 if exclude_self else 0)
    ids_out = np.empty((n, k), np.int32)
    d_out = np.empty((n, k), np.float32)
    with torch.no_grad():
        for s in range(0, n, q_chunk):
            e = min(s + q_chunk, n)
            dist, idx = topk_smallest(pairwise_sq_l2(qt[s:e], dbt), kk)
            if exclude_self:
                # drop the self-match; keep the first k others in rank order
                # (the self match may be absent under ties)
                keep = idx != torch.arange(s, e, device=device)[:, None]
                first = torch.sort((~keep).to(torch.int8), dim=1,
                                   stable=True).indices[:, :k]
                idx, dist = idx.gather(1, first), dist.gather(1, first)
            ids_out[s:e] = idx[:, :k].cpu().numpy()
            d_out[s:e] = dist[:, :k].cpu().numpy()
    return ids_out, d_out


def knn_graph(db, k: int, q_chunk: int = 2048, device="cuda") -> np.ndarray:
    """(N, k) KNN adjacency (ids), self excluded."""
    ids, _ = exact_knn(db, db, k, exclude_self=True, q_chunk=q_chunk,
                       device=device)
    return ids


def medoid(db: np.ndarray, device="cuda") -> int:
    """Approximate medoid: point closest to the dataset mean."""
    mean = np.asarray(db).mean(axis=0, keepdims=True)
    ids, _ = exact_knn(mean.astype(db.dtype), db, 1, device=device)
    return int(ids[0, 0])


def recall_at_k(pred_ids, true_ids, k: int) -> float:
    """Mean |pred ∩ true| / k over queries (duplicates in pred count once)."""
    p = np.asarray(pred_ids)[:, :k]
    t = np.asarray(true_ids)[:, :k]
    first = ~np.any(
        np.triu(p[:, :, None] == p[:, None, :], k=1), axis=1
    )  # the first occurrence of each id in its row
    hit = np.any(p[:, :, None] == t[:, None, :], axis=2) & first
    return float(hit.sum()) / (p.shape[0] * k)
