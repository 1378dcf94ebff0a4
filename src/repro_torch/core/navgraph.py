"""GATE navigation graph: connect each hub to its ``s`` most cosine-similar
hubs *in the learned latent space*, so a tiny greedy cosine search replaces
|V| model inferences per query (paper §4.3).  The graph is built on the host
(numpy, as ``repro``); the descent runs on ``device``, one lockstep walk over
the query batch."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class NavGraph:
    neighbors: np.ndarray  # (n_c, s) int32 hub-local ids
    reps: np.ndarray       # (n_c, d_out) L2-normalized hub latent reps
    start: int             # fixed entry hub for the greedy cosine descent


def build_nav_graph(hub_reps: np.ndarray, s: int = 8) -> NavGraph:
    """hub_reps must be L2-normalized (hub tower output)."""
    n_c = hub_reps.shape[0]
    s = min(s, n_c - 1)
    sim = hub_reps @ hub_reps.T  # cosine (normalized)
    np.fill_diagonal(sim, -np.inf)
    nbrs = np.argsort(-sim, axis=1)[:, :s].astype(np.int32)
    # start hub: medoid in latent space (max mean similarity — most central)
    np.fill_diagonal(sim, 0.0)
    start = int(np.argmax(sim.mean(axis=1)))
    return NavGraph(neighbors=nbrs, reps=hub_reps.astype(np.float32), start=start)


@dataclass
class NavGraphDevice:
    """Device-resident nav graph (tensors) for search."""

    reps: torch.Tensor
    neighbors: torch.Tensor
    start: int

    @classmethod
    def from_host(cls, nav: NavGraph, device="cuda") -> "NavGraphDevice":
        return cls(
            reps=torch.as_tensor(np.asarray(nav.reps), device=device),
            neighbors=torch.as_tensor(np.asarray(nav.neighbors), device=device).long(),
            start=int(nav.start),
        )


def descend(
    nav: NavGraphDevice,
    z_q: torch.Tensor,  # (B, d_out) normalized query reps
    *,
    max_hops: int = 16,
    probe_width: int = 1,
    instrument: bool = False,
):
    """Greedy cosine walk per query → hub-local entry id(s) (B, probe_width).

    probe_width > 1 returns the best hubs along the walk.  ``instrument=True``
    additionally returns the per-query descent length (B,).  The walk is
    lockstep over the batch: a query that stopped improving stays frozen.
    """
    reps, nbrs = nav.reps, nav.neighbors
    B = z_q.shape[0]
    dev = z_q.device
    rows = torch.arange(B, device=dev)
    cur = torch.full((B,), nav.start, dtype=torch.long, device=dev)
    cur_s = z_q @ reps[nav.start]
    trace_ids = torch.full((B, max_hops + 1), -1, dtype=torch.long, device=dev)
    trace_sim = torch.full((B, max_hops + 1), -torch.inf, device=dev)
    trace_ids[:, 0] = nav.start
    trace_sim[:, 0] = cur_s
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    hops = torch.zeros((B,), dtype=torch.int32, device=dev)
    for h in range(max_hops):
        active = ~done
        if not bool(active.any()):
            break
        cand = nbrs[cur]                                   # (B, s)
        cs = torch.einsum("bsd,bd->bs", reps[cand], z_q)
        j = torch.argmax(cs, dim=1)                        # first occurrence
        best, best_id = cs[rows, j], cand[rows, j]
        better = best > cur_s
        trace_ids[:, h + 1] = torch.where(active & better, best_id, -1)
        trace_sim[:, h + 1] = torch.where(active & better, best, -torch.inf)
        step = active & better
        cur = torch.where(step, best_id, cur)
        cur_s = torch.where(step, best, cur_s)
        hops = hops + active.to(torch.int32)
        done = done | (active & ~better)
    if probe_width == 1:
        ids = cur[:, None]
    else:
        order = torch.sort(-trace_sim, dim=1, stable=True).indices[:, :probe_width]
        picked = trace_ids.gather(1, order)
        ids = torch.where(picked < 0, cur[:, None], picked)
    return (ids, hops) if instrument else ids
