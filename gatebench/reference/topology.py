"""The hubs' topology tokens, worked out again from the graph (GATE §4.2).

For each hub, a walk of its ``h``-hop neighbourhood on the base graph: at
each node taken from the queue, its ``⌈x/2⌉`` nearest and ``⌈x/2⌉``
farthest neighbours (squared L2 in float32), ``x = ⌈min degree ÷ max
degree · degree⌉``, until ``max_nodes`` nodes; then Weisfeiler-Lehman
relabelling of that subgraph, each (iteration, label) feature-hashed with
a sign into ``d_u`` slots (blake2b, 8 bytes), one token an iteration,
each L2-normalised.  Initial labels are the node's degree bucket and its
hop bucket from the hub.  The construction the configuration's ``gate``
settings name (``h``, ``subgraph_max_nodes``, ``d_u``, ``wl_iters``,
``seed``), written plainly.
"""
from __future__ import annotations

import hashlib
from typing import List

import numpy as np


def _walk(db, neighbors, hub: int, h: int, max_nodes: int, ratio: float):
    """(nodes, edges (e, 2) local, hops) of the subgraph around ``hub``."""
    local = {hub: 0}
    hops = {hub: 0}
    edges = []
    queue = [hub]
    qi = 0
    while qi < len(queue) and len(local) < max_nodes:
        v = queue[qi]
        qi += 1
        row = neighbors[v]
        nbrs = row[row >= 0]
        if len(nbrs) == 0:
            continue
        half = int(np.ceil(max(int(np.ceil(ratio * len(nbrs))), 1) / 2))
        d = np.sum((db[nbrs].astype(np.float32) - db[v].astype(np.float32)) ** 2,
                   axis=1)
        order = np.argsort(d)
        for j in set(order[:half].tolist()) | set(order[-half:].tolist()):
            u = int(nbrs[j])
            if u not in local:
                if len(local) >= max_nodes:
                    break
                local[u] = len(local)
                hops[u] = hops[v] + 1
                if hops[u] < h:
                    queue.append(u)
            edges.append((local[v], local[u]))
    nodes = list(local)
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    if len(e):   # each undirected edge once, first occurrence kept
        key = np.minimum(e[:, 0], e[:, 1]) * len(nodes) + np.maximum(e[:, 0],
                                                                     e[:, 1])
        e = e[np.sort(np.unique(key, return_index=True)[1])]
    return nodes, e, np.array([hops[n] for n in nodes])


def _hash(s: str) -> int:
    return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8).digest(),
                          "little")


def _wl_tokens(n_nodes: int, edges, hops, d_u: int, wl_iters: int,
               seed: int) -> np.ndarray:
    toks = np.zeros((wl_iters + 1, d_u), np.float64)
    adj: List[List[int]] = [[] for _ in range(n_nodes)]
    for a, b in edges:
        if a != b:
            adj[int(a)].append(int(b))
            adj[int(b)].append(int(a))
    deg = np.array([len(a) for a in adj])
    labels = [f"d{a}h{b}" for a, b in zip(
        np.minimum(np.log2(deg + 1).astype(int), 7), np.minimum(hops, 7))]

    def add(it: int, tag: str):
        hv = _hash(f"{seed}:{tag}")
        toks[it, hv % d_u] += 1.0 if (hv >> 63) & 1 else -1.0

    for lab in labels:
        add(0, f"0:{lab}")
    for it in range(1, wl_iters + 1):
        labels = [format(_hash(labels[v] + "|" + ",".join(
            sorted(labels[u] for u in adj[v]))), "x") for v in range(n_nodes)]
        for lab in labels:
            add(it, f"{it}:{lab}")
    return toks / np.maximum(np.linalg.norm(toks, axis=1, keepdims=True), 1e-12)


def tokens(db: np.ndarray, neighbors: np.ndarray, hub_ids, gate: dict
           ) -> np.ndarray:
    """(hubs, wl_iters + 1, d_u) float32: every hub's topology tokens."""
    nb = np.asarray(neighbors)
    deg = (nb >= 0).sum(axis=1)
    nz = deg[deg > 0]
    ratio = max(int(nz.min()) if len(nz) else 1, 1) / max(int(deg.max()), 1)
    out = []
    for hub in np.asarray(hub_ids):
        nodes, edges, hops = _walk(db, nb, int(hub), gate["h"],
                                   gate["subgraph_max_nodes"], ratio)
        out.append(_wl_tokens(len(nodes), edges, hops, gate["d_u"],
                              gate["wl_iters"], gate["seed"]))
    return np.stack(out).astype(np.float32)
