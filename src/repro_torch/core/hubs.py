"""Hub node extraction (paper Definition 3).

Partition the database into ``n_c`` balanced clusters with HBKM, then pick
each cluster's medoid (nearest base vector to the centroid) as its hub node.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.hbkm import balanced_kmeans, hbkm
from repro_torch.graphs.knn import exact_knn


@dataclass
class HubSet:
    ids: np.ndarray        # (n_c,) base-db indices of hub nodes
    assign: np.ndarray     # (n,) cluster id per base vector
    centroids: np.ndarray  # (n_c, d)

    @property
    def n(self) -> int:
        return len(self.ids)


def extract_hubs(
    db: np.ndarray,
    n_c: int,
    *,
    branch_k: int = 8,
    lam: float = 1.0,
    iters: int = 8,
    seed: int = 0,
    device="cuda",
) -> HubSet:
    assign, centroids = hbkm(
        db, n_c, branch_k=branch_k, lam=lam, iters=iters, seed=seed,
        device=device,
    )
    dbt = torch.as_tensor(db, device=device)
    ids = np.zeros(centroids.shape[0], np.int64)
    for c in range(centroids.shape[0]):
        members = np.where(assign == c)[0]
        cen = centroids[c : c + 1].astype(db.dtype)
        if len(members) == 0:  # defensive: empty cluster → global nearest
            nn, _ = exact_knn(cen, dbt, 1, device=device)
            ids[c] = int(nn[0, 0])
            continue
        local, _ = exact_knn(
            cen, dbt[torch.as_tensor(members, device=dbt.device)], 1,
            device=device,
        )
        ids[c] = int(members[local[0, 0]])
    return HubSet(ids=ids, assign=assign, centroids=centroids)


def kmeans_hubs(db: np.ndarray, n_c: int, seed: int = 0, iters: int = 8,
                *, device="cuda") -> HubSet:
    """Ablation baseline (GATE w/o H): plain (unbalanced) k-means medoids."""
    assign, centroids = balanced_kmeans(
        db, n_c, lam=0.0, iters=iters, seed=seed, device=device,
    )
    dbt = torch.as_tensor(db, device=device)
    ids = np.zeros(n_c, np.int64)
    for c in range(n_c):
        members = np.where(assign == c)[0]
        cen = centroids[c : c + 1].astype(db.dtype)
        if len(members) == 0:
            nn, _ = exact_knn(cen, dbt, 1, device=device)
            ids[c] = int(nn[0, 0])
            continue
        local, _ = exact_knn(
            cen, dbt[torch.as_tensor(members, device=dbt.device)], 1,
            device=device,
        )
        ids[c] = int(members[local[0, 0]])
    return HubSet(ids=ids, assign=assign, centroids=centroids)
