"""The NSG's guarantees, checked on the graph the build produced.

Every edge names a row of the database (``-1`` pads a row), every row is
reachable from the navigating node (the build's connectivity repair
attaches the rest), and every hub is a distinct row: counts whose limit
is 0.  Each row's first ``R`` edges follow the NSG's edge selection
(MRNG, then the nearest pruned candidates up to ``R``), checked against
exact nearest neighbours (``prune_violations``).
"""
from __future__ import annotations

import numpy as np
import torch

from .knn import exact_knn


def bad_edges(neighbors: np.ndarray, n_rows: int) -> int:
    """Edges that name no row: ids below -1 or at least ``n_rows``."""
    nb = np.asarray(neighbors)
    return int(((nb < -1) | (nb >= n_rows)).sum())


def unreachable(neighbors: np.ndarray, enter: int, *, device) -> int:
    """Rows no path of edges reaches from ``enter`` (a breadth-first walk,
    one level a step)."""
    nb = torch.as_tensor(np.asarray(neighbors), device=device).long()
    n = nb.shape[0]
    seen = torch.zeros(n, dtype=torch.bool, device=device)
    seen[enter] = True
    frontier = torch.tensor([enter], device=device)
    while frontier.numel():
        nxt = nb[frontier].reshape(-1)
        nxt = nxt[(nxt >= 0) & (nxt < n)]
        nxt = torch.unique(nxt[~seen[nxt]])
        seen[nxt] = True
        frontier = nxt
    return int(n - seen.sum())


def bad_hubs(hub_ids, n_rows: int) -> int:
    """Hubs that name no row, or a row another hub names."""
    h = np.asarray(hub_ids)
    return int(((h < 0) | (h >= n_rows)).sum() + len(h) - len(np.unique(h)))


def prune_violations(db: np.ndarray, neighbors: np.ndarray, rows, R: int,
                     k: int, *, device, tol: float = 1e-3) -> float:
    """The share of pairs (p, x), ``p`` in ``rows`` and ``x`` one of p's
    ``k`` exact nearest other rows (float64), that p's first ``R`` edges
    ``E`` drop against the edge selection.  The selection takes the
    nearest candidate left, while fewer than ``R`` are taken, and drops
    every candidate nearer to it than to p; the build's candidates hold
    p's exact nearest rows.  So ``x`` is in ``E``, or some ``e`` in ``E``
    with ``d(p, e) <= d(p, x)`` has ``d(e, x) < d(p, x)``, or ``R`` edges
    lie at most ``d(p, x)`` from p.  ``tol`` (relative) leaves a float32
    build its rounding."""
    rows = np.asarray(rows)
    x = torch.as_tensor(db, device=device).to(torch.float64)
    near = exact_knn(db, db[rows], k + 1, device=device)
    near = np.stack([r[r != p][:k] for r, p in zip(near, rows)])
    e = torch.as_tensor(np.asarray(neighbors)[rows, :R], device=device).long()
    nx = torch.as_tensor(near, device=device)
    p = x[torch.as_tensor(rows, device=device)]
    ev, xv = x[e.clamp_min(0)], x[nx]
    d_pe = torch.where(e >= 0, ((ev - p[:, None]) ** 2).sum(-1), torch.inf)
    d_px = ((xv - p[:, None]) ** 2).sum(-1)
    d_ex = ((ev * ev).sum(-1)[:, :, None] - 2 * ev @ xv.transpose(1, 2)
            + (xv * xv).sum(-1)[:, None, :])
    lim = d_px * (1 + tol)
    nearer = d_pe[:, :, None] <= lim[:, None, :]
    kept = (e[:, :, None] == nx[:, None, :]).any(dim=1)
    occluded = (nearer & (d_ex < lim[:, None, :])).any(dim=1)
    full = nearer.sum(dim=1) >= R
    return float((~(kept | occluded | full)).double().mean())
