"""Query-aware sample generation (paper Definition 4).

``H(q, V_i)`` is the number of Algorithm-1 hops from hub ``V_i`` until the
top-1 neighbor of query ``q`` enters the beam (``greedy_hops``, the paper's
implementation and the default ``hop_mode="greedy"``), or the literal
shortest-path hop count from a reverse BFS (``hop_counts``,
``hop_mode="bfs"``; host numpy, as in ``repro``).

A query q is a POSITIVE for hub V_i if  H(q,V_i) ≤ min_q' H(q',V_i) + t_pos,
and a NEGATIVE if                      H(q,V_i) ≥ min_q' H(q',V_i) + t_neg.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.graphs.knn import exact_knn
from repro_torch.graphs.params import SearchParams
from repro_torch.graphs.search import batched_search


def _reverse_csr(neighbors: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """CSR of the reversed graph (v -> list of u with edge u->v)."""
    n, R = neighbors.shape
    src = np.repeat(np.arange(n, dtype=np.int64), R)
    dst = neighbors.reshape(-1).astype(np.int64)
    m = dst >= 0
    src, dst = src[m], dst[m]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, src


def hop_counts(
    neighbors: np.ndarray,   # (N, R) forward adjacency
    targets: np.ndarray,     # (Q,) top-1 node id per query
    hub_ids: np.ndarray,     # (n_c,) hub node ids
    max_hops: int = 64,
) -> np.ndarray:
    """(Q, n_c) hop count from each hub to each query's target (BFS);
    unreachable within max_hops → max_hops."""
    n = neighbors.shape[0]
    indptr, rev = _reverse_csr(neighbors)
    hub_pos = np.full(n, -1, np.int64)
    hub_pos[hub_ids] = np.arange(len(hub_ids))
    out = np.full((len(targets), len(hub_ids)), max_hops, np.int32)

    # dedup targets (many queries share a top-1)
    uniq, inv = np.unique(targets, return_inverse=True)
    dist = np.empty(n, np.int32)
    for ui, t in enumerate(uniq):
        dist.fill(-1)
        dist[t] = 0
        frontier = np.array([t], np.int64)
        hubs_left = len(hub_ids)
        row = np.full(len(hub_ids), max_hops, np.int32)
        if hub_pos[t] >= 0:
            row[hub_pos[t]] = 0
            hubs_left -= 1
        d = 0
        while len(frontier) and d < max_hops and hubs_left > 0:
            d += 1
            # gather all reverse neighbors of the frontier
            segs = [rev[indptr[v] : indptr[v + 1]] for v in frontier]
            if not segs:
                break
            nxt = np.unique(np.concatenate(segs)) if segs else frontier[:0]
            nxt = nxt[dist[nxt] < 0]
            if len(nxt) == 0:
                break
            dist[nxt] = d
            hp = hub_pos[nxt]
            hit = hp >= 0
            if hit.any():
                row[hp[hit]] = d
                hubs_left -= int(hit.sum())
            frontier = nxt
        out[inv == ui] = row[None, :]
    return out


def top1_targets(db, queries, device="cuda") -> np.ndarray:
    """Exact top-1 base id per query (the search target)."""
    ids, _ = exact_knn(queries, db, 1, device=device)
    return ids[:, 0].astype(np.int64)


def greedy_hops(
    db,
    neighbors,
    queries: np.ndarray,
    hub_ids: np.ndarray,
    targets: np.ndarray,
    *,
    beam_width: int = 16,
    max_hops: int = 64,
    chunk: int = 65536,
    device="cuda",
) -> np.ndarray:
    """Hops of Algorithm 1 from each hub until the target enters the beam,
    ``max_hops`` if it never does.  (Q, n_c).

    Every (query, hub) pair is one row of a lockstep batch of ``chunk`` pairs
    (``repro`` runs chunks of 64 queries × all hubs); the pairing changes no
    result.  The hop kernel computes ``repro``'s ``"xla"`` distance formula.
    """
    device = torch.device(device)
    dbt = torch.as_tensor(db, dtype=torch.float32, device=device)
    nbt = torch.as_tensor(neighbors, dtype=torch.int32, device=device)
    qt = torch.as_tensor(queries, dtype=torch.float32, device=device)
    hubs = torch.as_tensor(np.asarray(hub_ids), dtype=torch.int32, device=device)
    tgt = torch.as_tensor(np.asarray(targets), dtype=torch.int32, device=device)
    Q, H = qt.shape[0], hubs.shape[0]
    sp = SearchParams(k=beam_width, beam_width=beam_width, max_hops=max_hops,
                      kernel="fused")
    out = torch.empty((Q * H,), dtype=torch.int32, device=device)
    for s in range(0, Q * H, chunk):
        pair = torch.arange(s, min(s + chunk, Q * H), device=device)
        qi, hi = pair // H, pair % H
        res = batched_search(dbt, nbt, qt[qi], hubs[hi][:, None], sp,
                             device=device)
        found = (res.ids == tgt[qi][:, None]).any(dim=1)
        out[s:s + pair.numel()] = torch.where(found, res.hops, max_hops)
    return out.reshape(Q, H).cpu().numpy()


@dataclass
class SampleSet:
    """Per-hub positive / negative query queues (index into the query set)."""

    pos: List[np.ndarray]
    neg: List[np.ndarray]
    hop_matrix: np.ndarray  # (Q, n_c)

    def stats(self):
        return {
            "pos_mean": float(np.mean([len(p) for p in self.pos])),
            "neg_mean": float(np.mean([len(n) for n in self.neg])),
            "hub_with_no_pos": int(sum(len(p) == 0 for p in self.pos)),
        }


def make_samples(
    hop_matrix: np.ndarray,  # (Q, n_c)
    *,
    t_pos: int = 3,
    t_neg: int = 15,
    max_per_queue: int = 256,
    seed: int = 0,
) -> SampleSet:
    rng = np.random.default_rng(seed)
    Q, n_c = hop_matrix.shape
    pos, neg = [], []
    for i in range(n_c):
        col = hop_matrix[:, i]
        m = int(col.min())
        p = np.where(col <= m + t_pos)[0]
        n = np.where(col >= m + t_neg)[0]
        if len(p) > max_per_queue:
            p = rng.choice(p, max_per_queue, replace=False)
        if len(n) > max_per_queue:
            n = rng.choice(n, max_per_queue, replace=False)
        pos.append(np.sort(p))
        neg.append(np.sort(n))
    return SampleSet(pos=pos, neg=neg, hop_matrix=hop_matrix)
