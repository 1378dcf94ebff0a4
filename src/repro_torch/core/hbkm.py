"""Hierarchical Balanced K-Means (paper Algorithm 2).

Recursive k-way partitioning down to ``n_c`` leaf clusters, with the paper's
cluster-size penalty ``λ(|C_j| − |C|/k)²`` added to the assignment criterion.
Two assignment modes, as in ``repro``:

  * ``batch`` (default): every point picks
    ``argmin_j ‖x−μ_j‖² + λ_eff·(2 c_j − 2 |C|/k + 1)`` against the previous
    iteration's counts, one matrix product per iteration on ``device``.
  * ``greedy`` (paper-faithful): points are assigned one after another with
    the counts updated as they go.  The distances are one matrix product on
    ``device``; the sequential pass is the ``greedy_assign`` kernel (one
    warp walks the rows), then the centres are the members' means.

The recursion and the leaf-budget allocation are numpy, as in ``repro``.

``repro`` pads each split to a power of two to keep jit caches warm; the
padded rows are excluded from every count and sum, so the port does not pad.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.greedy_assign import greedy_assign


def _dists_to_centers(x, centers):
    return (
        torch.sum(x * x, dim=1, keepdim=True)
        - 2.0 * x @ centers.T
        + torch.sum(centers * centers, dim=1)[None, :]
    )


def _update_centers(x, assign, k):
    """Members' means; an empty cluster's centre becomes 0 (``repro``)."""
    oh = torch.nn.functional.one_hot(assign.long(), k).to(torch.float32)
    sums = oh.T @ x
    counts = torch.sum(oh, dim=0)
    return sums / torch.clamp_min(counts, 1.0)[:, None], counts


def _kmeans_greedy(x, centers, lam_eff, k, iters):
    """Paper-faithful sequential greedy k-means. Returns (assign, centers)."""
    target = float(torch.tensor(x.shape[0], dtype=torch.float32) / k)
    lam = float(lam_eff)
    assign = None
    for _ in range(iters):
        assign = greedy_assign(_dists_to_centers(x, centers).contiguous(),
                               lam, target)
        centers, _ = _update_centers(x, assign, k)
    return assign, centers


def _kmeans_batch(x, centers, lam_eff, k, iters):
    """Batch-synchronous balanced k-means. Returns (assign, centers)."""
    target = torch.tensor(x.shape[0], dtype=torch.float32) / k
    counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
    assign = None
    for _ in range(iters):
        d2 = _dists_to_centers(x, centers)
        pen = lam_eff * (2.0 * counts - 2.0 * target.to(x.device) + 1.0)
        assign = torch.argmin(d2 + pen[None, :], dim=1)
        oh = torch.nn.functional.one_hot(assign, k).to(torch.float32)
        counts_new = torch.sum(oh, dim=0)
        sums = oh.T @ x
        centers = torch.where(
            counts_new[:, None] > 0,
            sums / torch.clamp_min(counts_new, 1.0)[:, None],
            centers,
        )
        counts = counts_new
    return assign.to(torch.int32), centers


def balanced_kmeans(
    x: np.ndarray,
    k: int,
    *,
    lam: float = 1.0,
    iters: int = 8,
    seed: int = 0,
    mode: str = "batch",
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """One balanced k-means split. Returns (assignments (n,), centers (k,d))."""
    if mode not in ("batch", "greedy"):
        raise ValueError(mode)
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    idx = rng.choice(n, size=min(k, n), replace=False)
    centers = np.asarray(x[idx], np.float32)
    if len(idx) < k:
        centers = np.concatenate([centers, centers[: k - len(idx)]], axis=0)
    scale = float(np.mean(np.var(x, axis=0))) + 1e-12
    lam_eff = torch.tensor(lam * scale / max(n / k, 1.0), dtype=torch.float32,
                           device=device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    run = _kmeans_batch if mode == "batch" else _kmeans_greedy
    with torch.no_grad():
        assign, c = run(
            xt, torch.as_tensor(centers, device=device), lam_eff, k, iters)
    return assign.cpu().numpy(), c.cpu().numpy()


def hbkm(
    x: np.ndarray,
    n_c: int,
    *,
    branch_k: int = 8,
    lam: float = 1.0,
    iters: int = 8,
    seed: int = 0,
    mode: str = "batch",
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Hierarchical balanced k-means to exactly ``n_c`` leaf clusters.

    Returns (leaf assignment (n,) in [0, n_c), leaf centroids (n_c, d)).
    """
    n = x.shape[0]
    if not 1 <= n_c <= n:
        raise ValueError(f"hbkm: need 1 <= n_c <= n, got n_c={n_c}, n={n}")
    assign_out = np.zeros(n, np.int64)
    next_leaf = [0]

    def rec(idx: np.ndarray, target: int, depth: int):
        if target <= 1 or len(idx) <= 1:
            assign_out[idx] = next_leaf[0]
            next_leaf[0] += 1
            return
        k_here = int(min(branch_k, target, len(idx)))
        sub, _ = balanced_kmeans(
            x[idx], k_here, lam=lam, iters=iters,
            seed=seed + 7919 * depth + 13 * next_leaf[0], mode=mode,
            device=device,
        )
        sizes = np.bincount(sub, minlength=k_here).astype(np.float64)
        live = np.where(sizes > 0)[0]
        # proportional leaf-budget allocation (largest remainder), each ≥ 1,
        # and never more leaves than points in the child
        frac = sizes[live] / sizes[live].sum() * target
        alloc = np.maximum(np.floor(frac).astype(np.int64), 1)
        alloc = np.minimum(alloc, sizes[live].astype(np.int64))
        rem = target - alloc.sum()
        if rem > 0:
            room = sizes[live].astype(np.int64) - alloc
            order = np.argsort(-(frac - alloc))
            for j in order:
                if rem == 0:
                    break
                give = int(min(rem, room[j]))
                alloc[j] += give
                rem -= give
        elif rem < 0:
            order = np.argsort(frac - alloc)
            for j in order:
                if rem == 0:
                    break
                take = int(min(-rem, alloc[j] - 1))
                alloc[j] -= take
                rem += take
        for j, c in enumerate(live):
            rec(idx[sub == c], int(alloc[j]), depth + 1)

    rec(np.arange(n), n_c, 0)
    if next_leaf[0] != n_c:
        raise RuntimeError(f"hbkm produced {next_leaf[0]} leaves, wanted {n_c}")
    # per-leaf float64 sums in input order (np.add.at's order), per column
    counts = np.bincount(assign_out, minlength=n_c)
    centers = np.stack(
        [np.bincount(assign_out, weights=x[:, j], minlength=n_c)
         for j in range(x.shape[1])], axis=1,
    )
    centers /= np.maximum(counts, 1)[:, None]
    return assign_out.astype(np.int32), centers.astype(np.float32)


def cluster_size_variance(assign: np.ndarray, n_c: int) -> float:
    """The paper's balance objective: Σ (|C_i| − n/n_c)²."""
    counts = np.bincount(np.asarray(assign), minlength=n_c).astype(np.float64)
    return float(np.sum((counts - len(assign) / n_c) ** 2))
