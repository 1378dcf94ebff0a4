"""The benchmark's fixed arithmetic: peaks, roofline bounds, recall.

Frozen copies, so that what a number means cannot change with the
program: ``bound`` and ``hop_bound`` as ``chip_smoke.py`` has them (each
distinct valid row counted once), ``record_bounds`` after its
``record_calls``, and ``recall_at_k`` after ``repro_torch/graphs/knn.py``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import numpy as np

# NVIDIA H100 SXM, published (data sheet, dense): HBM3 bandwidth and fp32
# throughput outside the tensor cores.  The card's power limit is printed
# beside every run (``device.power_limit_w``): below 700 W the card runs
# slower than these peaks assume.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def bound(bytes_moved: float, ops: float) -> dict:
    """The least time (ms) the card could take for ``bytes_moved`` bytes and
    ``ops`` fp32 operations, and which of the two sets it."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "ops": ops}


def hop_bound(torch, ids, row_bytes: int, q_bytes: int, width: int) -> dict:
    """Bound of one hop-kernel call on its own ids (B, R): the ids read and
    the output written (4 bytes a slot each), each distinct valid row once
    (``row_bytes``), the query row (``q_bytes``) of each query that has a
    valid id; 3 operations per element of each valid slot."""
    valid = ids >= 0
    n_valid = int(valid.sum())
    rows = int(torch.unique(ids[valid]).numel())
    active = int(valid.any(dim=1).sum())
    return {**bound(ids.numel() * 8 + rows * row_bytes + active * q_bytes,
                    n_valid * width * 3),
            "valid_slots": n_valid, "distinct_rows": rows,
            "active_queries": active}


# the bytes of one row and of one query for each hop kernel, from the
# arguments it is called with: K1 (ids, db, q, inv) and K2 (ids, codes,
# scale, zero, q, inv)
def _k1_sizes(args):
    width = args[0].shape[1]
    return 4 * width, 4 * width, width


def _k2_sizes(args):
    codes, scale = args[0], args[1]
    width, nb = codes.shape[1], scale.shape[1]
    return width + 8 * nb, 4 * width, width


HOP_SIZES: Dict[str, Callable] = {
    "gather_rows_dist": _k1_sizes,
    "gather_rows_dist_q8": _k2_sizes,
}


@contextlib.contextmanager
def record_bounds(torch, module, name: str):
    """Replace ``module.<name>`` (a hop kernel as the search looks it up at
    call time) with a wrapper that adds each call's ``hop_bound`` to the
    yielded list, and put the function back after.  The bound is taken
    inside the wrapper, so no call's ids are kept."""
    orig = getattr(module, name)
    sizes = HOP_SIZES[name]
    bounds: List[dict] = []

    def wrapped(ids, *args, **kw):
        row_bytes, q_bytes, width = sizes(args)
        bounds.append(hop_bound(torch, ids, row_bytes, q_bytes, width))
        return orig(ids, *args, **kw)

    setattr(module, name, wrapped)
    try:
        yield bounds
    finally:
        setattr(module, name, orig)


def recall_at_k(pred_ids, true_ids, k: int) -> float:
    """Mean |pred ∩ true| / k over queries (duplicates in pred count once)."""
    return float(hits_at_k(pred_ids, true_ids, k).sum()) / (
        np.asarray(pred_ids).shape[0] * k)


def hits_at_k(pred_ids, true_ids, k: int) -> np.ndarray:
    """(B,) the number of a query's first ``k`` answers that are among its
    true ``k`` nearest (an id answered twice counts once)."""
    p = np.asarray(pred_ids)[:, :k]
    t = np.asarray(true_ids)[:, :k]
    first = ~np.any(np.triu(p[:, :, None] == p[:, None, :], k=1), axis=1)
    hit = np.any(p[:, :, None] == t[:, None, :], axis=2) & first
    return hit.sum(axis=1)

