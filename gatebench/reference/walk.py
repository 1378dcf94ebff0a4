"""Algorithm 1 of the GATE paper, written plainly: the query tower, the entry
hub, the beam search over the base graph, and the int8 walk's exact rerank.

The reference follows the program from the index the program built: the
graph, the hubs' rows and the towers' trained weights are the program's
build, handed over as numpy arrays.  Everything else is worked out again
here from them and from the queries: the hubs' topology tokens
(``topology``), the hub tower's forward pass (Eq. 3 and the projection)
and so every hub's representation, the query tower, the scores of every
hub, every distance, and for the int8 walk the codebook itself.

The beam search keeps, for each query, its ``L`` best rows by distance
(ties keep the earlier row: the beam before the new candidates, each in its
order), expands the best row not yet expanded (ties to the first slot),
and scores each of its neighbours that this query has not scored before.
It stops when every row of the beam is expanded or after ``max_hops``
expansions.  A row scored once and dropped cannot re-enter the beam (the
beam's ``L``-th distance only falls), so a visited set gives the answers
of a search that scores such a row again.

``dtype`` is the precision the distances and the tower are computed in:
float32 for the reference, bfloat16 for the control that stands in for a
program computed one precision lower.
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch

BLOCK_BYTES = 1 << 30   # the largest (B, R, d) block of gathered rows


@dataclass
class Index:
    """What the reference takes of the program's build."""

    neighbors: np.ndarray     # (N, R) int, -1 pads a row
    hub_ids: np.ndarray       # (H,) rows of the hubs
    hub_rows: np.ndarray      # (H, d) the hubs' vectors
    topo: np.ndarray          # (H, T, d_u) their topology tokens
    tower: dict               # both towers' weights, by the paper's names
    fusion: bool = True       # Eq. 3's attention over the tokens


@dataclass
class Walk:
    """The search as the configuration states it."""

    k: int
    beam_width: int
    max_hops: int
    rerank: int = 0           # > 0: int8 walk, then the exact rerank of the
    block: int = 128          # beam's first ``rerank`` rows; codebook block


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-9)


def _weights(index: Index, device, dtype) -> dict:
    return {k: torch.as_tensor(v, device=device).to(dtype)
            for k, v in index.tower.items()}


def hub_reps(index: Index, device, dtype=torch.float32) -> torch.Tensor:
    """(H, d_out) the hub tower's normalised output.  Eq. 3: each of the
    ``m`` heads attends from the hub's vector ``p W_Q`` over its tokens
    ``U W_K`` (scaled by ``1/√d_k``, softmax over the tokens) to ``U W_V``;
    the heads joined through ``W_O``, plus ``p W_P``.  Then ReLU(· H1 +
    b1) H2 + b2, normalised."""
    w = _weights(index, device, dtype)
    p = torch.as_tensor(index.hub_rows, device=device).to(dtype)
    f = p @ w["wp"]
    if index.fusion:
        u = torch.as_tensor(index.topo, device=device).to(dtype)
        d_k = w["wq"].shape[2]
        q = torch.einsum("hd,dmk->hmk", p, w["wq"])
        k = torch.einsum("htd,dmk->htmk", u, w["wk"])
        v = torch.einsum("htd,dmk->htmk", u, w["wv"])
        a = torch.softmax(torch.einsum("hmk,htmk->hmt", q, k) / d_k ** 0.5,
                          dim=-1)
        f = (torch.einsum("hmt,htmk->hmk", a, v).reshape(len(p), -1) @ w["wo"]
             + f)
    return _unit(torch.relu(f @ w["h1"] + w["hb1"]) @ w["h2"] + w["hb2"])


def entries(index: Index, queries: torch.Tensor, dtype, reps=None
            ) -> torch.Tensor:
    """(B,) the row of each query's entry hub: the query tower's MLP,
    normalised, against every hub's representation (``hub_reps``) by
    cosine; the best hub, ties to the first."""
    w = _weights(index, queries.device, dtype)
    q = queries.to(dtype)
    z = _unit(torch.relu(q @ w["q1"] + w["qb1"]) @ w["q2"] + w["qb2"])
    h = hub_reps(index, queries.device, dtype) if reps is None else reps
    best = torch.argmax((z @ h.T).to(torch.float32), dim=1)
    return torch.as_tensor(index.hub_ids, device=queries.device).long()[best]


def quantize(db: np.ndarray, block: int):
    """The int8 codebook of ``db``: per row and per ``block`` columns,
    ``scale = max((max(x, 0) − min(x, 0)) / 254, 1e-12)``, the integer zero
    point ``zp = round(−127 − min(x, 0) / scale)``, ``code = clip(round(x /
    scale) + zp, −127, 127)``; a row reads back as ``scale · code − scale ·
    zp``.  Rows are padded with zeros to whole blocks.  Returns the
    dequantized rows (N, nb · block) in float32."""
    x = np.asarray(db, np.float32)
    n, d = x.shape
    nb = max((d + block - 1) // block, 1)
    xp = np.zeros((n, nb * block), np.float32)
    xp[:, :d] = x
    blocks = xp.reshape(n, nb, block)
    mn = np.minimum(blocks.min(axis=2), 0.0)
    mx = np.maximum(blocks.max(axis=2), 0.0)
    scale = np.maximum((mx - mn) / 254.0, 1e-12).astype(np.float32)
    zp = np.round(-127.0 - mn / scale).astype(np.float32)
    codes = np.clip(np.round(blocks / scale[:, :, None]) + zp[:, :, None],
                    -127, 127).astype(np.int8)
    zero = (-scale * zp).astype(np.float32)
    deq = codes.astype(np.float32) * scale[:, :, None] + zero[:, :, None]
    return deq.reshape(n, nb * block)


def _sq_l2(rows: torch.Tensor, q: torch.Tensor, ids: torch.Tensor, dtype):
    """Squared L2 of the rows ``rows[ids]`` (B, X) to each query, in
    ``dtype``, as float32; +inf where an id is negative."""
    x = rows[ids.clamp_min(0)].to(dtype)
    d = ((x - q.to(dtype)[:, None, :]) ** 2).sum(dim=-1).to(torch.float32)
    return torch.where(ids >= 0, d, torch.inf)


def beam_search(rows: torch.Tensor, neighbors: torch.Tensor, q: torch.Tensor,
                entry: torch.Tensor, walk: Walk, dtype):
    """Algorithm 1 for a block of queries (module docstring).  Returns the
    beam's ids (B, L) and distances, best first, and each query's
    expansions (B,)."""
    B, n = q.shape[0], rows.shape[0]
    L = walk.beam_width
    dev = q.device
    at = torch.arange(B, device=dev)
    ids = torch.full((B, L), -1, dtype=torch.long, device=dev)
    dist = torch.full((B, L), torch.inf, device=dev)
    done = torch.zeros((B, L), dtype=torch.bool, device=dev)
    ids[:, 0] = entry
    dist[:, 0] = _sq_l2(rows, q, entry[:, None], dtype)[:, 0]
    seen = torch.zeros((B, n), dtype=torch.bool, device=dev)
    seen[at, entry] = True
    hops = torch.zeros(B, dtype=torch.long, device=dev)
    while True:
        open_ = ~done & (ids >= 0)
        live = open_.any(dim=1) & (hops < walk.max_hops)
        if not bool(live.any()):
            break
        j = torch.argmin(torch.where(open_, dist, torch.inf), dim=1)
        p = ids[at, j]
        done[at[live], j[live]] = True
        nb = neighbors[p.clamp_min(0)]
        ok = (nb >= 0) & live[:, None]
        ok &= ~seen.gather(1, nb.clamp_min(0))
        bi, ri = ok.nonzero(as_tuple=True)
        seen[bi, nb[bi, ri]] = True
        cand = torch.where(ok, nb, -1)
        all_ids = torch.cat([ids, cand], dim=1)
        all_d = torch.cat([dist, _sq_l2(rows, q, cand, dtype)], dim=1)
        all_done = torch.cat([done, torch.zeros_like(cand, dtype=torch.bool)], 1)
        order = torch.sort(all_d, dim=1, stable=True).indices[:, :L]
        keep = live[:, None]
        ids = torch.where(keep, all_ids.gather(1, order), ids)
        dist = torch.where(keep, all_d.gather(1, order), dist)
        done = torch.where(keep, all_done.gather(1, order), done)
        hops += live.long()
    return ids, dist, hops


def search(db: np.ndarray, index: Index, queries: np.ndarray, walk: Walk, *,
           device, dtype=torch.float32):
    """The reference's answers to ``queries``: ids (Q, k) int64, distances
    (Q, k) float32 and expansions (Q,), in blocks.  ``walk.rerank > 0``
    walks on the int8 codebook of ``db`` (``quantize``) and re-scores the
    beam's first ``walk.rerank`` rows exactly."""
    _no_tf32()
    db_t = torch.as_tensor(db, device=device)
    nb_t = torch.as_tensor(np.asarray(index.neighbors), device=device).long()
    walk_rows = db_t
    if walk.rerank:
        walk_rows = torch.as_tensor(quantize(db, walk.block), device=device)
    width = walk_rows.shape[1]
    per = max(1, BLOCK_BYTES // (nb_t.shape[1] * width * 4))
    per = min(per, max(1, BLOCK_BYTES // nb_t.shape[0]))   # the visited set
    reps = hub_reps(index, device, dtype)
    out_ids, out_d, out_h = [], [], []
    for s in range(0, len(queries), per):
        q = torch.as_tensor(queries[s:s + per], device=device)
        qw = q
        if walk.rerank:
            qw = torch.zeros((q.shape[0], width), device=device)
            qw[:, :q.shape[1]] = q
        e = entries(index, q, dtype, reps)
        ids, dist, hops = beam_search(walk_rows, nb_t, qw, e, walk, dtype)
        if walk.rerank:
            cand = ids[:, :walk.rerank]
            d_ex = _sq_l2(db_t, q, cand, dtype)
            d_ex, order = torch.sort(d_ex, dim=1, stable=True)
            ids, dist = cand.gather(1, order), d_ex
        out_ids.append(ids[:, :walk.k].cpu().numpy())
        out_d.append(dist[:, :walk.k].cpu().numpy())
        out_h.append(hops.cpu().numpy())
    return (np.concatenate(out_ids), np.concatenate(out_d),
            np.concatenate(out_h))
