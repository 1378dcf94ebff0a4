"""What decides ``correct``: the window's answers against the reference.

After the window, a sample of the answers it produced (drawn from the
seed, the queries with the most expansions among them) is searched again by
the plain reference (``reference.walk``) from the same queries, the
index's graph, its hubs' rows and the towers' trained weights; the
reference works out the hubs' topology tokens and representations itself.
The numbers compared, each against its limit from ``limits/<cell>.json``
(a number: at most; ``{"at_least": x}``: at least):

- ``id_mismatch``: the share of answer slots (query, rank) whose id is not
  the reference's;
- ``hops_mismatch``: the share of queries whose expansions differ;
- ``dist_gap``: the largest relative gap between a distance the program
  returned and the exact (float64) distance of the id it returned;
- ``sample_recall``: recall@10 of the sample against exact (float64)
  ground truth: what the build gives the search, the towers' training
  and the hubs included, which the reference takes from the program;
- ``bad_edges``, ``unreachable``, ``bad_hubs`` (limit 0) and
  ``prune_violations``: the NSG's guarantees and edge selection, checked
  on the graph itself, the build stage the reference does not do again.
"""
from __future__ import annotations

import numpy as np

from gatebench.reference import graph, knn, topology, walk
from gatebench.yardstick import hits_at_k

LONGEST = 32   # of the sample: the answered queries with the most expansions
PRUNE_ROWS = 2048   # rows whose edge selection is checked


def walk_of(cfg: dict, mix: dict) -> walk.Walk:
    s = {**cfg["search"], **mix.get("search", {})}
    if s.get("metric", "l2") != "l2":
        raise NotImplementedError("the reference walks squared L2 only")
    rerank = (min(s["beam_width"], s["k"] * s.get("rerank_mult", 4))
              if s.get("kernel") == "fused_q8" else 0)
    return walk.Walk(k=s["k"], beam_width=s["beam_width"],
                     max_hops=s["max_hops"], rerank=rerank)


def reference_index(db, state: dict, gate: dict) -> walk.Index:
    """The reference's index: the program's graph, hubs and tower weights,
    the topology tokens worked out again (``gate``: the configuration's
    GATE settings)."""
    if state["hub_ids"].size > gate["flat_score_max"] or gate["probe_width"] != 1:
        raise NotImplementedError(
            "the reference scores every hub for one entry: the configuration "
            "must keep n_hubs <= flat_score_max and probe_width = 1")
    hub_ids = state["hub_ids"]
    return walk.Index(state["neighbors"], hub_ids, db[hub_ids],
                      topology.tokens(db, state["neighbors"], hub_ids, gate),
                      state["tower"], gate["use_fusion"])


def sample(answers, pool, n: int, seed: int):
    """``n`` answered queries (or all, if fewer): the ``LONGEST`` with the
    most expansions, the rest drawn from the seed.  Returns their queries,
    ids, distances and expansions."""
    got = [a for a in answers if a.result is not None]
    where = np.array([(i, r) for i, a in enumerate(got)
                      for r in range(len(a.result["hops"]))])
    hops = np.concatenate([a.result["hops"] for a in got])
    n = min(n, len(where))
    longest = np.argsort(-hops, kind="stable")[:min(LONGEST, n)]
    rest = np.setdiff1d(np.arange(len(where)), longest)
    pick = np.concatenate([longest, np.random.default_rng(seed).choice(
        rest, n - len(longest), replace=False)])
    rows = where[pick]

    def field(name):
        return np.stack([got[i].result[name][r] for i, r in rows])

    q = np.stack([pool[got[i].pool][r] for i, r in rows])
    return q, field("ids"), field("dists"), field("hops")


def compare(db, index: walk.Index, q, ids, dists, hops, w: walk.Walk,
            device, truth=None) -> dict:
    """The sample's numbers against the reference's search of the same
    queries on ``index`` (``truth``: the sample's exact k nearest, if
    known)."""
    r_ids, _, r_hops = walk.search(db, index, q, w, device=device)
    exact = knn.sq_l2(db, q, ids, device=device)
    ok = ids >= 0
    gap = np.abs(dists.astype(np.float64) - exact)[ok] / np.maximum(
        exact[ok], 1e-30)
    if truth is None:
        truth = knn.exact_knn(db, q, w.k, device=device)
    return {"id_mismatch": float(np.mean(ids != r_ids)),
            "hops_mismatch": float(np.mean(hops != r_hops)),
            "dist_gap": float(gap.max()) if gap.size else 0.0,
            "sample_recall": float(hits_at_k(ids, truth, w.k).sum())
            / (len(ids) * w.k)}


def graph_numbers(db, state: dict, nsg: dict, seed: int, device) -> dict:
    """The graph's and the hubs' guarantees; the edge selection on
    ``PRUNE_ROWS`` rows drawn from ``seed``, against each row's
    ``knn_k // 2`` exact nearest (the build's float32 kNN list may swap
    rows that tie at its last places)."""
    nb = state["neighbors"]
    rows = np.random.default_rng(seed).choice(
        len(db), min(PRUNE_ROWS, len(db)), replace=False)
    return {"bad_edges": graph.bad_edges(nb, len(db)),
            "unreachable": graph.unreachable(nb, state["enter_id"],
                                             device=device),
            "bad_hubs": graph.bad_hubs(state["hub_ids"], len(db)),
            "prune_violations": graph.prune_violations(
                db, nb, rows, nsg["R"], nsg["knn_k"] // 2, device=device)}


def recall(db, pool, answers, k: int, device) -> float:
    """recall@k of every answer against exact ground truth, each pool batch's
    truth computed once."""
    truth, hits, n = {}, 0, 0
    for a in answers:
        if a.result is None:
            continue
        if a.pool not in truth:
            truth[a.pool] = knn.exact_knn(db, pool[a.pool], k, device=device)
        hits += int(hits_at_k(a.result["ids"], truth[a.pool], k).sum())
        n += len(a.result["ids"]) * k
    return hits / n


def within(value: float, limit) -> bool:
    """``limit`` a number: at most it; ``{"at_least": x}``: at least x;
    ``None`` (no limit): never."""
    if isinstance(limit, dict):
        return value >= limit["at_least"]
    return limit is not None and value <= limit


def judge(numbers: dict, limits: dict):
    """``(correct, checks)``: every number within its limit; ``checks`` maps
    each name to its value and limit.  A number without a limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    return all(within(c["value"], c["limit"]) for c in checks.values()), checks
