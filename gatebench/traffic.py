"""The one generator every traffic mix is read by.

A mix is a JSON file of parameters (``traffic/<name>.json``), served as a
closed loop: batches back to back, the next one sent when the last one's
answers are in.

- ``batch``: queries a batch; ``pool``: how many batches the pool holds,
  cycled through;
- ``ood_fraction`` (optional): the share of out-of-distribution queries,
  else the configuration's;
- ``search``: what the mix changes of the configuration's search
  (``kernel``, ``rerank_mult``);
- ``check_sample``: how many answered queries the reference checks.

The dataset, the query log the index is trained on and the pool of
queries served are the configuration's, one fixed draw from
``data_seed``, as a deployment's files and workload are: every run builds
the same index and serves the same queries, batch by batch, in the same
order.  A run's seed orders each batch's queries (and draws the sample
the reference checks).  So every seed gives the card the same work.  A
batch runs as long as its longest query: a pool drawn from the seed
changed that work (QPS spread 3-4% over seeds where a seed's two runs
agreed within 1%), and so did the order of the batches, in a window that
ends inside a cycle of the pool.

The out-of-distribution queries are the training log's: one rotation and
shift (``make_queries_ood``'s, drawn as the log's OOD half draws it), and
rows and noise of their own.  Text queries come from one text encoder; a
transform drawn per run would serve each run a distribution the towers
never saw.
"""
from __future__ import annotations

import numpy as np

from gatebench import data


def seeds(seed: int) -> dict:
    """Independent sub-seeds of a run's ``--seed``: the order of each
    batch's queries and the reference's sample."""
    s = np.random.SeedSequence(int(seed)).generate_state(2)
    return dict(zip(("order", "sample"), (int(v) for v in s)))


def database(cfg: dict) -> np.ndarray:
    """The configuration's dataset: one fixed draw (``data_seed``), the
    same in every run, as a deployment's files are."""
    return data.make_database(cfg["profile"], cfg["rows"],
                              seed=cfg["data_seed"])[0]


def ood_transform(db: np.ndarray, n_q: int, seed: int):
    """The rotation (d, d) and shift (d,) that ``data.make_queries_ood(db,
    n_q, seed=seed)`` applies: the same draws from the same stream."""
    rng = np.random.default_rng(seed)
    d = db.shape[1]
    rng.integers(0, db.shape[0], n_q)
    a = rng.standard_normal((d, d)).astype(np.float32) / np.sqrt(d)
    m = np.eye(d, dtype=np.float32) + 0.35 * (a - a.T) / 2
    qmat, _ = np.linalg.qr(m)
    shift = rng.standard_normal(d).astype(np.float32) * 0.3 * db.std()
    return qmat, shift


def ood_queries(db: np.ndarray, n_q: int, seed: int, transform) -> np.ndarray:
    """``n_q`` out-of-distribution queries under ``transform``: rows and
    noise (``make_queries_ood``'s 0.15) drawn from ``seed``."""
    qmat, shift = transform
    rng = np.random.default_rng(seed)
    out = db[rng.integers(0, db.shape[0], n_q)] @ qmat.T + shift
    out += rng.standard_normal(out.shape).astype(np.float32) * db.std() * 0.15
    return out.astype(np.float32)


def queries(cfg: dict, mix: dict, db: np.ndarray, order_seed: int):
    """The query log the index is trained on and the pool of query
    batches served (``mix["pool"]`` of ``mix["batch"]`` queries), both
    fixed by ``data_seed``; each batch's queries put in the order
    ``order_seed`` draws."""
    s = cfg["data_seed"]
    train, _ = data.train_eval_query_split(
        db, cfg["train_queries"], 0, seed=s + 1,
        ood_fraction=cfg["ood_fraction"])
    n = mix["pool"] * mix["batch"]
    n_ood = int(n * mix.get("ood_fraction", cfg["ood_fraction"]))
    parts = [data.make_queries_in_dist(db, n - n_ood, seed=s + 10)]
    if n_ood:
        # the log's OOD half is make_queries_ood(seed=s + 3) of this many
        n_log = int(cfg["train_queries"] * cfg["ood_fraction"])
        parts.append(ood_queries(db, n_ood, s + 11,
                                 ood_transform(db, n_log, s + 3)))
    pool = np.concatenate(parts)
    np.random.default_rng(s + 12).shuffle(pool)
    pool = pool.reshape(mix["pool"], mix["batch"], db.shape[1])
    rng = np.random.default_rng(order_seed)
    return train, np.stack([b[rng.permutation(len(b))] for b in pool])
