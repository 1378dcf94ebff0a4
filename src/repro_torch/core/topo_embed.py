"""Topology features via Weisfeiler-Lehman feature hashing.

A numpy copy of ``repro.core.topo_embed``, with the same output.

The paper embeds each hub's sampled subgraph with Graph2Vec [43] — a doc2vec
model over WL subtree labels.  Offline doc2vec training is replaced here by
the *deterministic* core of the same construction: iterated WL relabeling
over the subgraph, with every (iteration, label) occurrence feature-hashed
(signed hashing trick) into a fixed ``d_u``-dim vector, then L2-normalized.
This keeps the role (structural signature of the sampled subgraph; two hubs
with similar local topology get nearby features) without a learned embedding
stage (an offline adaptation of the paper).

Per-WL-iteration signatures are kept as SEPARATE TOKENS — ``wl_embed_tokens``
returns ``(wl_iters+1, d_u)`` — so the fusion attention (Eq. 3) attends over
a real sequence (iteration 0 = degree/hop histogram … iteration T = deep
structure) instead of a single pooled vector, which would make the softmax
degenerate.  ``wl_embed`` is the pooled (summed+normalized) variant.

Initial labels combine degree buckets and hop-distance-from-hub buckets so
the signature is hub-centric, not just a generic graph fingerprint.
"""
from __future__ import annotations

import hashlib
from typing import List

import numpy as np

from repro_torch.core.subgraph import Subgraph


def _hash64(s: str) -> int:
    return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8).digest(), "little")


def wl_embed_tokens(
    sg: Subgraph,
    d_u: int,
    *,
    wl_iters: int = 3,
    seed: int = 0,
) -> np.ndarray:
    """(wl_iters+1, d_u) per-iteration WL signatures, each L2-normalized."""
    m = len(sg.nodes)
    toks = np.zeros((wl_iters + 1, d_u), np.float32)
    if m == 0:
        return toks
    adj: List[List[int]] = [[] for _ in range(m)]
    for a, b in sg.edges:
        if a != b:
            adj[int(a)].append(int(b))
            adj[int(b)].append(int(a))
    deg = np.array([len(a) for a in adj])
    deg_b = np.minimum(np.log2(deg + 1).astype(int), 7)
    hop_b = np.minimum(sg.hops, 7)
    labels = [f"d{db}h{hb}" for db, hb in zip(deg_b, hop_b)]

    def accumulate(it: int, tag: str):
        hv = _hash64(f"{seed}:{tag}")
        idx = hv % d_u
        sign = 1.0 if (hv >> 63) & 1 else -1.0
        toks[it, idx] += sign

    for lab in labels:
        accumulate(0, f"0:{lab}")
    for it in range(1, wl_iters + 1):
        new_labels = []
        for v in range(m):
            neigh = sorted(labels[u] for u in adj[v])
            sig = labels[v] + "|" + ",".join(neigh)
            nl = format(_hash64(sig), "x")
            new_labels.append(nl)
            accumulate(it, f"{it}:{nl}")
        labels = new_labels
    norms = np.linalg.norm(toks, axis=1, keepdims=True)
    return toks / np.maximum(norms, 1e-12)


def wl_embed(sg: Subgraph, d_u: int, *, wl_iters: int = 3, seed: int = 0) -> np.ndarray:
    """(d_u,) pooled structural signature (sum of iteration tokens, renormed)."""
    toks = wl_embed_tokens(sg, d_u, wl_iters=wl_iters, seed=seed)
    vec = toks.sum(axis=0)
    n = np.linalg.norm(vec)
    return vec / n if n > 0 else vec


def embed_all(
    subgraphs: List[Subgraph],
    d_u: int,
    *,
    wl_iters: int = 3,
    seed: int = 0,
) -> np.ndarray:
    """(n_hubs, wl_iters+1, d_u) topology feature tokens for every hub."""
    return np.stack(
        [wl_embed_tokens(sg, d_u, wl_iters=wl_iters, seed=seed) for sg in subgraphs]
    )
