"""The benchmark's data: a frozen copy of the port's synthetic generators.

``make_database``, ``make_queries_in_dist``, ``make_queries_ood`` and
``train_eval_query_split`` as ``repro_torch/data/synthetic.py`` has them
(the same seed gives the same arrays), kept here so that the data the
benchmark measures on cannot change with the program.  Profiles carry the
widths of the GATE paper's Table 2.
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


PROFILES: Dict[str, DatasetProfile] = {
    "gist1m-like": DatasetProfile("gist1m-like", 960, 64),
    "laion3m-like": DatasetProfile("laion3m-like", 512, 96),
    "tiny5m-like": DatasetProfile("tiny5m-like", 384, 128),
    "sift10m-like": DatasetProfile("sift10m-like", 128, 160),
    "text2image10m-like": DatasetProfile("text2image10m-like", 200, 128),
}


def make_database(profile: str, n: int, seed: int = 0,
                  dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """(vectors (n, d), cluster of each row (n,)): a Gaussian mixture with
    Zipf-like cluster sizes and per-cluster anisotropic scales."""
    p = PROFILES[profile]
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((p.n_clusters, p.dim)).astype(np.float32)
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


def make_queries_in_dist(db: np.ndarray, n_q: int, seed: int = 1,
                         noise: float = 0.05) -> np.ndarray:
    """In-distribution queries: perturbed base rows (image to image)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, db.shape[0], n_q)
    scale = db.std() * noise
    return (
        db[idx] + rng.standard_normal((n_q, db.shape[1])).astype(np.float32) * scale
    )


def make_queries_ood(db: np.ndarray, n_q: int, seed: int = 2,
                     rotation_strength: float = 0.35, bias: float = 0.3,
                     noise: float = 0.15) -> np.ndarray:
    """Out-of-distribution queries (text to image): base rows under a fixed
    partial rotation, a shift and noise."""
    rng = np.random.default_rng(seed)
    d = db.shape[1]
    idx = rng.integers(0, db.shape[0], n_q)
    base = db[idx]
    a = rng.standard_normal((d, d)).astype(np.float32) / np.sqrt(d)
    m = np.eye(d, dtype=np.float32) + rotation_strength * (a - a.T) / 2
    qmat, _ = np.linalg.qr(m)
    shift = rng.standard_normal(d).astype(np.float32) * bias * db.std()
    out = base @ qmat.T + shift
    out += rng.standard_normal(out.shape).astype(np.float32) * db.std() * noise
    return out.astype(np.float32)


def train_eval_query_split(db: np.ndarray, n_train: int, n_eval: int,
                           seed: int = 3, ood_fraction: float = 0.0
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Historical (training) queries and held-out evaluation queries from one
    process, ``ood_fraction`` of each out of distribution, shuffled."""
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
