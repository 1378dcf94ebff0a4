"""Mixture-of-experts FFN (counterpart of ``repro.models.moe``): the
dense-dispatch baseline and the capacity-based dispatch.

``impl="dense"`` computes *every* expert for *every* token and combines by
the router weight (no token dropping; 1 − topk/E of the expert products
are wasted, as in ``repro``).

``impl="dropping"`` is the GShard-style sort-based dispatch: tokens are
routed into fixed-capacity per-expert buffers, the experts run as one
batched product, and each token sums its kept slots' outputs weighted.
The tokens are split into the data-parallel groups of the sharding
context's mesh (``_dp_groups``: the mesh's size over ``act_batch``'s axes),
each group dispatched on its own with its own capacity, as ``repro`` does;
off a mesh, or where the batch does not split evenly, that is one group.
This is the one place where ``ctx`` changes a value.

The expert products are plain PyTorch: ``repro`` computes them with
``jnp.einsum`` outside any Pallas kernel.  Top-k ties go to the lowest
expert id (``lax.top_k``'s order), from a stable descending sort: bf16
router logits tie often.  The dropping combine gathers each token's K
slot outputs and sums them in slot order, so two runs give the same bits
(``repro``'s scatter-add has no such promise on a GPU).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoESpec
from repro_torch.distributed.sharding import NULL_CTX, ShardingCtx, mesh_shape
from repro_torch.models.common import ParamSpec, Params, acc_dtype


def moe_param_table(cfg: ModelConfig, prefix: str,
                    stacked: int) -> Dict[str, ParamSpec]:
    moe = cfg.moe
    assert moe is not None
    d, fe = cfg.d_model, moe.expert_d_ff or cfg.d_ff
    E = moe.num_experts
    lead = (stacked,) if stacked else ()
    lax = ("layers",) if stacked else ()
    t = {
        f"{prefix}router": ParamSpec(lead + (d, E), lax + ("embed", "experts")),
        f"{prefix}we_gate": ParamSpec(
            lead + (E, d, fe), lax + ("experts", "embed", "ff")),
        f"{prefix}we_up": ParamSpec(
            lead + (E, d, fe), lax + ("experts", "embed", "ff")),
        f"{prefix}we_down": ParamSpec(
            lead + (E, fe, d), lax + ("experts", "ff", "embed")),
    }
    if moe.shared_experts:
        # repro's width: shared_d_ff per shared expert, times their count
        fs = (moe.shared_d_ff or fe) * moe.shared_experts
        t[f"{prefix}ws_gate"] = ParamSpec(lead + (d, fs), lax + ("embed", "ff"))
        t[f"{prefix}ws_up"] = ParamSpec(lead + (d, fs), lax + ("embed", "ff"))
        t[f"{prefix}ws_down"] = ParamSpec(lead + (fs, d), lax + ("ff", "embed"))
        t[f"{prefix}shared_gate"] = ParamSpec(lead + (d, 1),
                                              lax + ("embed", None))
    return t


def top_k_lowest_first(probs: torch.Tensor, k: int):
    """The ``k`` largest of the last axis, descending, ties to the lowest
    index (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _router(x: torch.Tensor, w_router: torch.Tensor, moe: MoESpec):
    """Returns (weights (B,S,k), expert ids (B,S,k), aux load-balance loss).

    The logits are computed in the compute dtype, then widened to float32
    (float64 for a float64 model) for the softmax, as ``repro`` does."""
    at = acc_dtype(x.dtype)
    logits = (x @ w_router.to(x.dtype)).to(at)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = top_k_lowest_first(probs, moe.experts_per_token)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    # Switch-style load-balance aux: E * sum(frac_tokens_e * frac_prob_e)
    E = probs.shape[-1]
    experts = torch.arange(E, device=x.device)
    one_hot = (top_ids[..., 0, None] == experts).to(at)
    frac_tokens = torch.mean(one_hot, dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return top_w, top_ids, aux


def _glu(x, wg, wu, wd, ctx=NULL_CTX):
    h = ctx.constrain(F.silu(x @ wg) * (x @ wu), ("act_batch", None, "act_ff"))
    return h @ wd


def moe_ffn(x: torch.Tensor, p: Params, prefix: str, cfg: ModelConfig,
            ctx: ShardingCtx = NULL_CTX) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), aux loss scalar in float32)."""
    moe = cfg.moe
    assert moe is not None
    dt = x.dtype
    top_w, top_ids, aux = _router(x, p[f"{prefix}router"], moe)

    if moe.impl == "dense":
        out = _dense_dispatch(x, p, prefix, cfg, top_w, top_ids, ctx)
    elif moe.impl == "dropping":
        out = _dropping_dispatch(x, p, prefix, cfg, top_w, top_ids, ctx)
    else:
        raise ValueError(moe.impl)

    if moe.shared_experts:
        shared = _glu(x, p[f"{prefix}ws_gate"].to(dt), p[f"{prefix}ws_up"].to(dt),
                      p[f"{prefix}ws_down"].to(dt))
        sg = torch.sigmoid(x @ p[f"{prefix}shared_gate"].to(dt))
        out = out + sg * shared
    return out.to(dt), aux.to(torch.float32)


def _dense_dispatch(x, p, prefix, cfg, top_w, top_ids, ctx):
    """Every expert computed for every token, in expert order 0…E−1,
    each added into the carry in the compute dtype by its routing weight
    (zero for the experts a token did not pick): six kernels an expert,
    the weighted add one ``addcmul_``."""
    E = cfg.moe.num_experts
    dt = x.dtype
    combine = torch.zeros(top_ids.shape[:-1] + (E,), dtype=top_w.dtype,
                          device=x.device).scatter(-1, top_ids, top_w)
    comb = combine.to(dt)[..., None]  # (B, S, E, 1)
    experts = zip(*(p[f"{prefix}{n}"].to(dt).unbind(0)
                    for n in ("we_gate", "we_up", "we_down")),
                  comb.unbind(2))
    out = torch.zeros_like(x)
    for wg, wu, wd, comb_e in experts:
        out.addcmul_(_glu(x, wg, wu, wd, ctx), comb_e)
    return out


def capacity(tokens: int, moe: MoESpec) -> int:
    """Slots per expert for one group of ``tokens`` tokens."""
    K, E = moe.experts_per_token, moe.num_experts
    return max(int(np.ceil(tokens * K / E * moe.capacity_factor)), 1)


def _scatter_group(xf, ids, E, K, cap, dt):
    """Sort ONE token group (T, D) into (E, cap, D) buffers.  Returns
    (buf, keep, gather-index, order) for the combine step; ``keep`` marks
    the (sorted) token slots that fit their expert's capacity."""
    T, D = xf.shape
    flat_e = ids.reshape(-1)  # (T*K,)
    order = torch.argsort(flat_e, stable=True)  # stable: token order kept
    sorted_e = flat_e[order]
    idx_in_group = (torch.arange(T * K, device=xf.device)
                    - torch.searchsorted(sorted_e, sorted_e, side="left"))
    keep = idx_in_group < cap
    slot = sorted_e * cap + idx_in_group
    # out-of-capacity slots land on one spare row, cut off after
    dest = torch.where(keep, slot, E * cap)
    buf = torch.zeros((E * cap + 1, D), dtype=dt, device=xf.device)
    buf[dest] = xf[order // K].to(dt)
    src = torch.where(keep, slot, 0)
    return buf[:E * cap].reshape(E, cap, D), keep, src, order


def _combine_group(y_flat, keep, src, order, wts, dt):
    """Each token's K slot outputs, weighted, summed in slot order (no
    scatter-add, so the sum's order is fixed)."""
    T, K = wts.shape
    vals = torch.where(keep[:, None], y_flat[src], 0.0)  # (T*K, D), sorted
    w_slot = wts.reshape(-1)[order][:, None].to(dt)
    contrib = torch.empty_like(vals)
    contrib[order] = vals * w_slot  # back to (token, slot) order
    contrib = contrib.reshape(T, K, -1)
    out = contrib[:, 0]
    for j in range(1, K):
        out = out + contrib[:, j]
    return out


def _dp_groups(ctx) -> int:
    """Number of data-parallel shards the token axis is split over."""
    if ctx is None or ctx.mesh is None or ctx.profile is None:
        return 1
    rule = ctx.profile.rules.get("act_batch")
    if rule is None:
        return 1
    axes = (rule,) if isinstance(rule, str) else rule
    sizes = mesh_shape(ctx.mesh)
    g = 1
    for a in axes:
        g *= sizes.get(a, 1)
    return g


def _dropping_dispatch(x, p, prefix, cfg, top_w, top_ids, ctx):
    """GShard capacity dispatch, group-local: the batch splits into the
    ``_dp_groups(ctx)`` data-parallel groups (one where B does not divide),
    each group's T/G tokens are sorted into their own buffers of capacity
    ``ceil(T/G·K/E·capacity_factor)`` per expert, the slots past it dropped
    (their tokens keep the other experts' and the shared output).  The
    expert products run once over every group's buffers."""
    moe = cfg.moe
    E, K = moe.num_experts, moe.experts_per_token
    B, S, D = x.shape
    dt = x.dtype
    G = _dp_groups(ctx)
    if B % G or (B // G) == 0:
        G = 1  # ragged batch: fall back to one global group
    t_loc = B * S // G
    cap = capacity(t_loc, moe)
    xg = ctx.constrain(x.reshape(G, t_loc, D), ("act_batch", None, None))
    idsg = top_ids.reshape(G, t_loc, K)
    wtsg = top_w.reshape(G, t_loc, K)
    groups = [_scatter_group(xg[g], idsg[g], E, K, cap, dt) for g in range(G)]
    buf = ctx.constrain(torch.stack([gr[0] for gr in groups]),
                        ("act_batch", None, None, None))  # (G, E, cap, D)
    wg, wu, wd = (p[f"{prefix}{n}"].to(dt)
                  for n in ("we_gate", "we_up", "we_down"))
    be = buf.transpose(0, 1).reshape(E, G * cap, D)  # every group, by expert
    h = F.silu(torch.bmm(be, wg)) * torch.bmm(be, wu)
    h = ctx.constrain(h.reshape(E, G, cap, -1).transpose(0, 1),
                      ("act_batch", None, None, "act_ff"))
    y = torch.bmm(h.transpose(0, 1).reshape(E, G * cap, -1), wd)
    y = ctx.constrain(y.reshape(E, G, cap, D).transpose(0, 1),
                      ("act_batch", None, None, None))
    out = torch.stack([
        _combine_group(y[g].reshape(E * cap, D), keep, src, order, wtsg[g], dt)
        for g, (_, keep, src, order) in enumerate(groups)])
    out = ctx.constrain(out, ("act_batch", None, None))
    return out.reshape(B, S, D)
