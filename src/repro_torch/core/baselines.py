"""Competitor entry-point strategies (§5 baselines), all over the SAME base
graph so the comparison isolates entry selection — the paper's variable:

  * medoid    — NSG default (single global entry)
  * random    — HNSW-flat style (random entries)
  * kmtree    — "HVS-like": hierarchical k-means tree descended by plain
                vector distance (multi-layer coarse-to-fine entry selection,
                no topology/query awareness)
  * hash      — "LSH-APG-like": signed-random-projection hash over the hub
                set; entry = nearest hub in the query's bucket probe

The k-means splits, the leaf medoids and the leaf scores run on ``device``;
the hash codes are host numpy, as in ``repro``.  Imported by module path
(``repro_torch.core`` does not export them, as ``repro.core`` does not).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.core.hbkm import balanced_kmeans
from repro_torch.graphs.knn import exact_knn, pairwise_sq_l2


# --------------------------------------------------------------------- kmtree
@dataclass
class KMeansTree:
    """Hierarchy of k-means centroids; leaves map to base-db entry points."""

    levels: List[np.ndarray]       # centroids per level, (k_i, d)
    children: List[np.ndarray]     # (k_i,) start index of children at l+1
    leaf_entry: np.ndarray         # (k_last,) base-db id nearest each leaf


def build_kmeans_tree(
    db: np.ndarray, branch: int = 8, depth: int = 3, seed: int = 0,
    *, device="cuda",
) -> KMeansTree:
    levels, children = [], []
    parents = [np.arange(len(db))]
    for lvl in range(depth):
        next_parents: List[np.ndarray] = []
        cents = []
        child_of = np.zeros(len(parents), np.int64)
        for ci, members in enumerate(parents):
            child_of[ci] = len(next_parents)
            if len(members) <= branch:
                for m_ in members:
                    cents.append(db[m_])
                    next_parents.append(np.array([m_]))
                continue
            a, c = balanced_kmeans(
                db[members], branch, lam=0.0, iters=6,
                seed=seed + lvl * 131 + ci, device=device,
            )
            for j in range(branch):
                sel = members[a == j]
                if len(sel) == 0:
                    continue
                cents.append(c[j])
                next_parents.append(sel)
        levels.append(np.asarray(cents, np.float32))
        children.append(child_of)
        parents = next_parents
    dbt = torch.as_tensor(db, device=device)
    leaf_entry = np.zeros(len(parents), np.int64)
    for i, members in enumerate(parents):
        cent = levels[-1][i : i + 1]
        loc, _ = exact_knn(
            cent.astype(db.dtype),
            dbt[torch.as_tensor(members, device=dbt.device)], 1, device=device,
        )
        leaf_entry[i] = members[loc[0, 0]]
    return KMeansTree(levels=levels, children=children, leaf_entry=leaf_entry)


def kmtree_entries(tree: KMeansTree, queries, *, device="cuda") -> np.ndarray:
    """Greedy descend the tree by L2; (B, 1) base-db entry ids."""
    # flat approximation: nearest leaf centroid (equivalent entry quality,
    # single batched matmul — the tree structure matters for build cost only)
    d = pairwise_sq_l2(
        torch.as_tensor(queries, dtype=torch.float32, device=device),
        torch.as_tensor(tree.levels[-1], device=device),
    )
    leaf = torch.argmin(d, dim=1).cpu().numpy()
    return tree.leaf_entry[leaf][:, None].astype(np.int32)


# ----------------------------------------------------------------------- hash
@dataclass
class HashProbe:
    planes: np.ndarray     # (n_bits, d) random projections
    hub_codes: np.ndarray  # (n_hubs,) packed sign codes
    hub_ids: np.ndarray    # (n_hubs,) base-db ids


def build_hash_probe(
    db: np.ndarray, hub_ids: np.ndarray, n_bits: int = 16, seed: int = 0
) -> HashProbe:
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((n_bits, db.shape[1])).astype(np.float32)
    codes = _codes(db[hub_ids], planes)
    return HashProbe(planes=planes, hub_codes=codes, hub_ids=hub_ids)


def _codes(x: np.ndarray, planes: np.ndarray) -> np.ndarray:
    bits = (x @ planes.T) > 0
    return (bits * (1 << np.arange(planes.shape[0]))).sum(axis=1).astype(
        np.uint32
    )


def hash_entries(probe: HashProbe, queries: np.ndarray) -> np.ndarray:
    """Entry = hub with minimum hamming distance to the query code (B, 1)."""
    qc = _codes(queries, probe.planes)
    x = qc[:, None] ^ probe.hub_codes[None, :]
    # popcount via uint8 view
    ham = np.unpackbits(
        x.astype(">u4").view(np.uint8).reshape(len(queries), -1, 4), axis=-1
    ).sum(axis=(-1))
    best = np.argmin(ham, axis=1)
    return probe.hub_ids[best][:, None].astype(np.int32)
