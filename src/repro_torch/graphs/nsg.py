"""NSG construction (Fu et al., VLDB'19) — the paper's underlying graph index.

Pipeline, as ``repro.graphs.nsg``:
  1. exact KNN graph (graphs/knn.py)
  2. medoid as navigating node
  3. per-node candidate pool: batched beam search of the node itself over the
     KNN graph (+ a few random long edges) ∪ its KNN list
  4. MRNG edge selection, vectorized over a batch of nodes
  5. reverse-edge insertion up to the degree cap R; connectivity repair from
     the medoid.
Every stage runs on ``device``; the host loops of ``repro`` (reverse edges,
the reachability walk) are written as whole-graph tensor operations with the
same result.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.graphs.knn import exact_knn, knn_graph, medoid
from repro_torch.graphs.params import SearchParams
from repro_torch.graphs.search import batched_search


@dataclass
class NSG:
    neighbors: np.ndarray  # (N, R) int32, -1 padded
    enter_id: int
    R: int
    # wall seconds of each construction stage (t_knn, t_search_prune,
    # t_reverse_edges, t_repair; device synchronized) and the repair's
    # unreachable nodes and waves
    build_stats: Dict[str, float] = field(default_factory=dict)

    @property
    def n(self):
        return self.neighbors.shape[0]

    def degree_stats(self):
        deg = (self.neighbors >= 0).sum(axis=1)
        return dict(
            min=int(deg.min()), max=int(deg.max()), mean=float(deg.mean())
        )


def _mrng_prune_batch(node_vecs, cand_ids, cand_vecs, R):
    """Vectorized MRNG selection.

    node_vecs: (B, d); cand_ids: (B, P) sorted by distance to node (-1 pad);
    cand_vecs: (B, P, d).  Returns (B, R) selected ids (-1 pad).
    """
    B, P, d = cand_vecs.shape
    dev = cand_ids.device
    nv = node_vecs.to(torch.float32)
    cv = cand_vecs.to(torch.float32)
    d_node = torch.sum((cv - nv[:, None, :]) ** 2, dim=-1)
    d_node = torch.where(cand_ids < 0, torch.inf, d_node)
    sq = torch.sum(cv * cv, dim=-1)
    d_pair = (sq[:, :, None] - 2 * torch.einsum("bpd,bqd->bpq", cv, cv)
              + sq[:, None, :])
    rows = torch.arange(B, device=dev)
    slots = torch.arange(R, device=dev)[None, :]
    suppressed = torch.zeros((B, P), dtype=torch.bool, device=dev)
    selected = torch.full((B, R), -1, dtype=torch.int32, device=dev)
    n_sel = torch.zeros((B,), dtype=torch.int32, device=dev)
    for _ in range(P):
        avail = ~suppressed & (cand_ids >= 0)
        dm = torch.where(avail, d_node, torch.inf)
        j = torch.argmin(dm, dim=1)
        ok = torch.isfinite(dm[rows, j]) & (n_sel < R)
        picked = cand_ids[rows, j]
        selected = torch.where(
            ok[:, None] & (slots == n_sel[:, None]), picked[:, None], selected)
        # suppress candidates closer to the picked one than to the node
        supp_new = d_pair[rows, j] < d_node
        suppressed = suppressed | (ok[:, None] & supp_new)
        suppressed[rows, j] = True
        n_sel = n_sel + ok.to(torch.int32)

    # fill remaining slots with the nearest pruned candidates (pure MRNG
    # pruning leaves the graph too sparse to navigate)
    order = torch.sort(d_node, dim=1, stable=True).indices
    for i in range(P):
        cid = cand_ids[rows, order[:, i]]
        dup = (selected == cid[:, None]).any(dim=1)
        ok = ~dup & (cid >= 0) & (n_sel < R)
        selected = torch.where(
            ok[:, None] & (slots == n_sel[:, None]), cid[:, None], selected)
        n_sel = n_sel + ok.to(torch.int32)
    return selected


def _dedup_rows(pool: torch.Tensor) -> torch.Tensor:
    """-1 out every repeat of an id within its row (first occurrence kept)."""
    srt, srt_idx = torch.sort(pool, dim=1, stable=True)
    dup_sorted = torch.cat(
        [torch.zeros_like(srt[:, :1], dtype=torch.bool), srt[:, 1:] == srt[:, :-1]],
        dim=1,
    )
    dup = torch.zeros_like(dup_sorted).scatter(1, srt_idx, dup_sorted)
    return torch.where(dup, -1, pool)


def build_nsg(
    db: np.ndarray,
    *,
    R: int = 32,
    knn_k: int = 32,
    search_l: int = 64,
    pool_size: int = 96,
    batch: Optional[int] = None,
    seed: int = 0,
    aug_random: int = 4,
    device="cuda",
) -> NSG:
    """Build the NSG of ``db`` on ``device``.  ``batch`` nodes are searched
    and pruned together (default 1024 on CPU, 8192 on CUDA); it changes no
    result, only the memory and launch count per step."""
    device = torch.device(device)
    if batch is None:
        batch = 8192 if device.type == "cuda" else 1024
    n, d = db.shape
    stats: Dict[str, float] = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats[f"t_{name}"] = time.perf_counter() - t0
        t0 = time.perf_counter()

    dbt = torch.as_tensor(db, device=device)
    knn = torch.as_tensor(knn_graph(dbt, knn_k, device=device), device=device)
    enter = medoid(db, device=device)
    lap("knn")
    # candidate-generation substrate: KNN rows + a few random long edges per
    # node, so clustered data still yields cross-cluster candidates
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, n, (n, aug_random)).astype(np.int32)
    sub = torch.cat([knn, torch.as_tensor(rand, device=device)], dim=1)

    # the hop kernel computes repro's default "xla" distance formula
    sp = SearchParams(k=search_l, beam_width=search_l, max_hops=search_l,
                      kernel="fused")
    out = torch.full((n, R), -1, dtype=torch.int32, device=device)
    with torch.no_grad():
        for s in range(0, n, batch):
            e = min(s + batch, n)
            entry = torch.full((e - s, 1), enter, dtype=torch.int32, device=device)
            res = batched_search(dbt, sub, dbt[s:e], entry, sp, device=device)
            # pool = search results ∪ own KNN row (dedup; self removed)
            pool = torch.cat([res.ids, knn[s:e]], dim=1)[:, :pool_size + 8]
            node_idx = torch.arange(s, e, device=device)[:, None]
            pool = torch.where(pool == node_idx, -1, pool)
            pool = _dedup_rows(pool)[:, :pool_size].contiguous()
            cand_vecs = dbt[pool.clamp_min(0).long()]
            out[s:e] = _mrng_prune_batch(dbt[s:e], pool, cand_vecs, R)
        lap("search_prune")
        out = _add_reverse_edges(out, R)
        lap("reverse_edges")
        nbrs = _repair_connectivity(dbt, out, enter, stats)
        lap("repair")
    return NSG(neighbors=nbrs, enter_id=enter, R=nbrs.shape[1],
               build_stats=stats)


def _add_reverse_edges(neighbors: torch.Tensor, R: int) -> torch.Tensor:
    """Insert v→u for each u→v where v has a free slot (NSG inter-insert).

    ``repro`` walks the edges u-major in Python; each v then receives, in
    ascending u, the sources u with u→v and no v→u edge, up to R − deg(v).
    Rows hold distinct ids, so that order is reproduced by one stable sort of
    the edges by v.  Updates ``neighbors`` in place and returns it.
    """
    n, width = neighbors.shape
    dev = neighbors.device
    deg0 = (neighbors >= 0).sum(dim=1)
    u = torch.arange(n, device=dev).repeat_interleave(width)
    v = neighbors.reshape(-1).long()
    m = v >= 0
    u, v = u[m], v[m]
    has_rev = torch.isin(v * n + u, u * n + v)
    keep = ~has_rev & (deg0[v] < R)
    u, v = u[keep], v[keep]
    v, order = torch.sort(v, stable=True)
    u = u[order]
    counts = torch.bincount(v, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    pos = deg0[v] + torch.arange(v.numel(), device=dev) - starts[v]
    ok = pos < R
    neighbors[v[ok], pos[ok]] = u[ok].to(neighbors.dtype)
    return neighbors


def _reachable(neighbors: torch.Tensor, enter: int) -> torch.Tensor:
    """(N,) bool: nodes reachable from ``enter`` (level-synchronous BFS)."""
    n = neighbors.shape[0]
    seen = torch.zeros(n, dtype=torch.bool, device=neighbors.device)
    seen[enter] = True
    frontier = torch.tensor([enter], device=neighbors.device)
    while frontier.numel():
        nb = neighbors[frontier].reshape(-1).long()
        nb = torch.unique(nb[nb >= 0])
        frontier = nb[~seen[nb]]
        seen[frontier] = True
    return seen


def _repair_connectivity(dbt, neighbors: torch.Tensor, enter,
                         stats: Optional[Dict[str, float]] = None) -> np.ndarray:
    """Attach every node unreachable from the medoid to its nearest reachable
    node (NSG tree_grow).  Rows may overflow the degree cap — the adjacency
    is re-padded to the new max degree.  Returns host numpy; ``stats`` gets
    the number of unreachable nodes and of repair waves."""
    stats = {} if stats is None else stats
    seen_t = _reachable(neighbors, enter)
    nbrs = neighbors.cpu().numpy()
    stats["repair_nodes"] = int((~seen_t).sum())
    stats["repair_waves"] = 0
    if bool(seen_t.all()):
        return nbrs
    seen = seen_t.cpu().numpy()
    n, R = nbrs.shape
    extra = np.zeros(n, np.int64)
    att_r, att_m = [], []  # repair edges r -> m, in the order repro adds them
    cap = 4  # bounded repair fanout: chains spread over waves
    while not seen.all():
        stats["repair_waves"] += 1
        missing = np.where(~seen)[0]
        reach_ids = np.where(seen)[0]
        ids, d = exact_knn(dbt[torch.as_tensor(missing, device=dbt.device)],
                           dbt[torch.as_tensor(reach_ids, device=dbt.device)],
                           1, device=dbt.device)
        order = np.argsort(d[:, 0])
        # repro walks ``order`` and lets each anchor take missing nodes until
        # it holds ``cap`` repair edges; so an anchor takes its first
        # cap − extra candidates in that order (rank within a stable sort)
        anchor = reach_ids[ids[order, 0]]
        by_anchor = np.argsort(anchor, kind="stable")
        grouped = anchor[by_anchor]
        rank = np.arange(len(grouped)) - np.searchsorted(grouped, grouped)
        take = np.zeros(len(order), bool)
        take[by_anchor] = rank < cap - extra[grouped]
        r_new, m_new = anchor[take], missing[order[take]]
        np.add.at(extra, r_new, 1)
        seen[m_new] = True
        att_r.append(r_new)
        att_m.append(m_new)
        if len(m_new) == 0:  # all nearest anchors saturated: relax the cap
            cap *= 2
    deg = (nbrs >= 0).sum(axis=1)
    new_R = max(R, int((deg + extra).max()))
    out = np.full((n, new_R), -1, np.int32)
    out[:, :R] = nbrs
    r_all, m_all = np.concatenate(att_r), np.concatenate(att_m)
    by_r = np.argsort(r_all, kind="stable")
    r_all, m_all = r_all[by_r], m_all[by_r]
    pos = deg[r_all] + np.arange(len(r_all)) - np.searchsorted(r_all, r_all)
    out[r_all, pos] = m_all
    return out
