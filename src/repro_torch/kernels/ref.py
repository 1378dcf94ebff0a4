"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function computes what its hand-written CUDA kernel computes.  The
wrappers in ``gather_dist`` / ``twotower_score`` / ``greedy_assign`` run
these on CPU tensors
(and under ``SearchParams(kernel_interpret=True)``); the tests compare them
with ``repro``'s Pallas kernels, and ``chip_smoke.py`` compares the CUDA
kernels with them on the card.
"""
from __future__ import annotations

import torch

INF = 3.4e38  # python float: rounds to the same float32 as repro's INF


def gather_rows_dist_ref(ids, db, q, inv_norms=None):
    """(B, R) masked distances of ``db[ids]`` to each row of ``q``.

    ``inv_norms is None``: squared L2 ``Σ(v − q)²``.  Otherwise cosine
    ``1 − Σ(v·inv[v]·q̂)`` with ``q`` pre-normalized.  ``id < 0`` → INF.
    """
    safe = ids.clamp_min(0).long()
    v = db[safe].to(torch.float32)                     # (B, R, d)
    qf = q.to(torch.float32)[:, None, :]
    if inv_norms is None:
        d = torch.sum((v - qf) ** 2, dim=-1)
    else:
        vn = v * inv_norms[safe][..., None]
        d = 1.0 - torch.sum(vn * qf, dim=-1)
    return torch.where(ids >= 0, d, INF)


def dequant_rows(ids, codes, scale, zero):
    """(B, R, Dp) float32 rows of the int8 codebook (``id < 0`` reads row 0)."""
    safe = ids.clamp_min(0).long()
    nb = scale.shape[1]
    dp = codes.shape[1]
    c = codes[safe].to(torch.float32).reshape(*ids.shape, nb, dp // nb)
    v = c * scale[safe][..., None] + zero[safe][..., None]
    return v.reshape(*ids.shape, dp)


def gather_rows_dist_q8_ref(ids, codes, scale, zero, q, inv_norms=None):
    """(B, R) approximate masked distances from the int8 codebook; ``q`` is
    (B, Dp), zero-padded to the code width (pad dims dequantize to 0.0)."""
    v = dequant_rows(ids, codes, scale, zero)
    qf = q.to(torch.float32)[:, None, :]
    if inv_norms is None:
        d = torch.sum((v - qf) ** 2, dim=-1)
    else:
        vn = v * inv_norms[ids.clamp_min(0).long()][..., None]
        d = 1.0 - torch.sum(vn * qf, dim=-1)
    return torch.where(ids >= 0, d, INF)


def l2dist_ref(q, c):
    """(Q, d) × (C, d) → (Q, C) squared L2 ``‖q‖² − 2q·c + ‖c‖²``, fp32,
    clamped at 0 (a matrix product, not a kernel of the port)."""
    qf = q.to(torch.float32)
    cf = c.to(torch.float32)
    qn = torch.sum(qf * qf, dim=1, keepdim=True)
    cn = torch.sum(cf * cf, dim=1, keepdim=True)
    return torch.clamp_min(qn - 2.0 * (qf @ cf.T) + cn.T, 0.0)


def topk_min_ref(d, k: int):
    """(B, C) → (values (B, k) ascending, indices (B, k) int32); among equal
    values the lowest index comes first, as ``lax.top_k`` orders them.  A
    stable sort of the whole row, because ``torch.topk`` picks freely among
    values equal to the k-th."""
    vals, idx = torch.sort(d.to(torch.float32), dim=1, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


def gather_dist_ref(vecs, q, ids):
    """(B, R, d) pre-gathered rows, (B, d) queries, (B, R) ids → (B, R)
    masked squared L2 in the difference form ``Σ(v − q)²``; INF where
    ``id < 0``."""
    vf = vecs.to(torch.float32)
    qf = q.to(torch.float32)
    d = torch.sum((vf - qf[:, None, :]) ** 2, dim=-1)
    return torch.where(ids >= 0, torch.clamp_min(d, 0.0), INF)


def twotower_score_ref(q, h):
    """(B, d) × (H, d) → (B, H) cosine similarity, fp32.

    The norm is clamped at 1e-9 as ``repro.kernels.ref`` does; the CUDA
    kernel clamps the *squared* norm at 1e-18 as the TPU kernel does.
    """
    qf = q.to(torch.float32)
    hf = h.to(torch.float32)
    qn = qf / torch.clamp_min(torch.linalg.norm(qf, dim=1, keepdim=True), 1e-9)
    hn = hf / torch.clamp_min(torch.linalg.norm(hf, dim=1, keepdim=True), 1e-9)
    return qn @ hn.T


def greedy_assign_ref(d2, lam_eff: float, target: float):
    """(n, k) squared distances → (n,) int32: row after row, the argmin of
    ``d2[i] + lam·((2·counts − 2·target) + 1)`` (ties to the lowest j),
    then ``counts[j] += 1`` — ``repro``'s ``_assign_greedy`` scan, in
    float32, one PyTorch op per term so each rounds on its own."""
    n, k = d2.shape
    dev = d2.device
    lam = torch.tensor(lam_eff, dtype=torch.float32, device=dev)
    two_t = 2.0 * torch.tensor(target, dtype=torch.float32, device=dev)
    counts = torch.zeros((k,), dtype=torch.float32, device=dev)
    out = torch.empty((n,), dtype=torch.int64, device=dev)
    d2 = d2.to(torch.float32)
    for i in range(n):
        pen = lam * ((2.0 * counts - two_t) + 1.0)
        j = torch.argmin(d2[i] + pen)
        counts[j] += 1.0
        out[i] = j
    return out.to(torch.int32)
