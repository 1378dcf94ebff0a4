"""Guided-walk subgraph sampling around hub nodes (paper §4.2, Figure 4).

A numpy copy of ``repro.core.subgraph``, with the same output.

For each hub node, explore its h-hop neighborhood on the proximity graph with
a queue-driven walk.  At each dequeued node v we sample ``⌈x/2⌉`` *nearest*
and ``⌈x/2⌉`` *farthest* neighbors of v (by Euclidean distance among v's graph
neighbors), where the fanout adapts to the degree distribution:

    x = ceil( MinDegree(G) / MaxDegree(G) * degree(v) )

Sampled nodes within h hops of the hub are enqueued.  The result is an edge
list (local subgraph) per hub — consumed by core.topo_embed.

This is an offline, index-build-time procedure (numpy; the paper builds it
once per index).  Distances use the base vectors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class Subgraph:
    nodes: np.ndarray   # (m,) base-db ids, nodes[0] == hub id
    edges: np.ndarray   # (e, 2) local indices into ``nodes``
    hops: np.ndarray    # (m,) hop distance from hub


def _degree(neighbors: np.ndarray) -> np.ndarray:
    return (neighbors >= 0).sum(axis=1)


def sample_subgraph(
    db: np.ndarray,
    neighbors: np.ndarray,  # (N, R) padded adjacency
    hub: int,
    *,
    h: int = 5,
    max_nodes: int = 256,
    min_deg: int | None = None,
    max_deg: int | None = None,
    seed: int = 0,
) -> Subgraph:
    if min_deg is None or max_deg is None:
        deg = _degree(neighbors)
    if min_deg is None:
        nz = deg[deg > 0]
        min_deg = int(nz.min()) if len(nz) else 1
    if max_deg is None:
        max_deg = int(deg.max()) if len(deg) else 1
    ratio = max(min_deg, 1) / max(max_deg, 1)

    local: Dict[int, int] = {int(hub): 0}
    hops = {int(hub): 0}
    edges: List[Tuple[int, int]] = []
    queue: List[int] = [int(hub)]
    qi = 0
    while qi < len(queue) and len(local) < max_nodes:
        v = queue[qi]
        qi += 1
        hv = hops[v]
        row = neighbors[v]
        nbrs = row[row >= 0]
        if len(nbrs) == 0:
            continue
        x = int(np.ceil(ratio * len(nbrs)))
        x = max(x, 1)
        half = int(np.ceil(x / 2))
        d = np.sum((db[nbrs].astype(np.float32) - db[v].astype(np.float32)) ** 2, axis=1)
        order = np.argsort(d)
        pick = set(order[:half].tolist()) | set(order[-half:].tolist())
        for j in pick:
            u = int(nbrs[j])
            if u not in local:
                if len(local) >= max_nodes:
                    break
                local[u] = len(local)
                hops[u] = hv + 1
                if hv + 1 < h:
                    queue.append(u)
            edges.append((local[v], local[u]))

    nodes = np.fromiter(local.keys(), np.int64, len(local))
    hop_arr = np.fromiter((hops[int(n)] for n in nodes), np.int32, len(nodes))
    if edges:
        e = np.asarray(edges, np.int64)
        # dedup undirected edges
        lo = np.minimum(e[:, 0], e[:, 1])
        hi = np.maximum(e[:, 0], e[:, 1])
        key = lo * len(nodes) + hi
        _, first = np.unique(key, return_index=True)
        e = e[np.sort(first)]
    else:
        e = np.zeros((0, 2), np.int64)
    return Subgraph(nodes=nodes, edges=e, hops=hop_arr)


def sample_all_subgraphs(
    db: np.ndarray,
    neighbors: np.ndarray,
    hub_ids: np.ndarray,
    *,
    h: int = 5,
    max_nodes: int = 256,
    seed: int = 0,
) -> List[Subgraph]:
    deg = _degree(neighbors)
    nz = deg[deg > 0]
    min_deg = int(nz.min()) if len(nz) else 1
    max_deg = int(deg.max()) if len(deg) else 1
    return [
        sample_subgraph(
            db, neighbors, int(hub), h=h, max_nodes=max_nodes,
            min_deg=min_deg, max_deg=max_deg, seed=seed + i,
        )
        for i, hub in enumerate(hub_ids)
    ]
