"""Synthetic vector databases + query generators.

A numpy copy of ``repro.data.synthetic``: the same seed gives the same data.

The paper's five datasets (Gist1M/Laion3M/Tiny5M/Sift10M/Text2Image10M) are
not available offline; these generators produce matched-profile surrogates:

 * clusterability (§3 of the paper): GMM with per-cluster anisotropic scales —
   "dense intra-cluster, sparse inter-cluster" structure that HBKM exploits;
 * in-distribution queries: cluster samples + noise (image→image retrieval);
 * out-of-distribution queries (modality gap, Fig. 6): a fixed random rotation
   + bias + noise applied to base samples — preserves neighborhood structure
   weakly while shifting the query distribution, reproducing the text→image
   mismatch phenomenon (longer search paths from distribution-blind entries).

Profiles mirror the paper's Table 2 dims (scaled N for CPU).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class DatasetProfile:
    name: str
    dim: int
    n_clusters: int
    cluster_spread: float = 0.25   # intra-cluster stddev scale
    anisotropy: float = 4.0        # per-cluster axis scale ratio


# dims follow the paper's Table 2
PROFILES: Dict[str, DatasetProfile] = {
    "gist1m-like": DatasetProfile("gist1m-like", 960, 64),
    "laion3m-like": DatasetProfile("laion3m-like", 512, 96),
    "tiny5m-like": DatasetProfile("tiny5m-like", 384, 128),
    "sift10m-like": DatasetProfile("sift10m-like", 128, 160),
    "text2image10m-like": DatasetProfile("text2image10m-like", 200, 128),
}


def make_database(
    profile: str | DatasetProfile,
    n: int,
    seed: int = 0,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (vectors (n, d), cluster assignment (n,))."""
    p = PROFILES[profile] if isinstance(profile, str) else profile
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((p.n_clusters, p.dim)).astype(np.float32)
    # zipf-ish cluster sizes: real embedding data is imbalanced
    w = 1.0 / np.arange(1, p.n_clusters + 1) ** 0.6
    w /= w.sum()
    assign = rng.choice(p.n_clusters, size=n, p=w)
    scales = rng.uniform(1.0, p.anisotropy, size=(p.n_clusters, p.dim)).astype(
        np.float32
    )
    scales *= p.cluster_spread / np.sqrt(p.dim)
    noise = rng.standard_normal((n, p.dim)).astype(np.float32)
    x = centers[assign] + noise * scales[assign]
    return x.astype(dtype), assign.astype(np.int32)


def make_queries_in_dist(
    db: np.ndarray, n_q: int, seed: int = 1, noise: float = 0.05
) -> np.ndarray:
    """In-distribution queries: perturbed base points (image→image)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, db.shape[0], n_q)
    scale = db.std() * noise
    return (
        db[idx] + rng.standard_normal((n_q, db.shape[1])).astype(np.float32) * scale
    )


def make_queries_ood(
    db: np.ndarray, n_q: int, seed: int = 2,
    rotation_strength: float = 0.35, bias: float = 0.3, noise: float = 0.15,
) -> np.ndarray:
    """Out-of-distribution queries (text→image style modality gap)."""
    rng = np.random.default_rng(seed)
    d = db.shape[1]
    idx = rng.integers(0, db.shape[0], n_q)
    base = db[idx]
    # partial random rotation: Q = I + strength * skew, orthogonalized
    a = rng.standard_normal((d, d)).astype(np.float32) / np.sqrt(d)
    m = np.eye(d, dtype=np.float32) + rotation_strength * (a - a.T) / 2
    qmat, _ = np.linalg.qr(m)
    shift = rng.standard_normal(d).astype(np.float32) * bias * db.std()
    out = base @ qmat.T + shift
    out += rng.standard_normal(out.shape).astype(np.float32) * db.std() * noise
    return out.astype(np.float32)


def train_eval_query_split(
    db: np.ndarray, n_train: int, n_eval: int, seed: int = 3,
    ood_fraction: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Historical (training) queries + held-out eval queries, same process —
    the paper's assumption that query distributions are 'relatively
    consistent' over time (§4.2)."""
    n_ood_t = int(n_train * ood_fraction)
    n_ood_e = int(n_eval * ood_fraction)
    tr = [make_queries_in_dist(db, n_train - n_ood_t, seed=seed)]
    ev = [make_queries_in_dist(db, n_eval - n_ood_e, seed=seed + 1)]
    if n_ood_t:
        tr.append(make_queries_ood(db, n_ood_t, seed=seed + 2))
    if n_ood_e:
        ev.append(make_queries_ood(db, n_ood_e, seed=seed + 3))
    rngt = np.random.default_rng(seed + 4)
    train = np.concatenate(tr)
    rngt.shuffle(train)
    evalq = np.concatenate(ev)
    rngt.shuffle(evalq)
    return train, evalq
