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
This is the one place where ``ctx`` changes a value.  On a DTensor each
rank sorts, scatters and combines the groups it holds as plain tensors
(DTensor has no strategy for the sort's ``searchsorted`` or the scatter's
index put): the groups are the data-parallel shards the rows already lie
in, so no token moves between ranks, and only the expert products run on
DTensors, the buffers sharded on their group dimension.

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
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig, MoESpec
from repro_torch.distributed.sharding import NULL_CTX, ShardingCtx, mesh_shape
from repro_torch.models.common import (
    ParamSpec, Params, acc_dtype, from_shard, to_shard,
)


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
    step = _block_rows(T * K)
    for lo in range(0, T * K, step):
        buf[dest[lo:lo + step]] = xf[order[lo:lo + step] // K].to(dt)
    src = torch.where(keep, slot, 0)
    return buf[:E * cap].reshape(E, cap, D), keep, src, order


# the blocks a scatter or a combine moves a group's rows in: its rows
# gathered for the buffers, or its weighted slot outputs, never stand
# whole beside those buffers.  A count, not a size: the dispatch runs the
# same ops at every length, as the dry run's traced lengths assume
DISPATCH_BLOCKS = 8


def _block_rows(n: int) -> int:
    return max(-(-n // DISPATCH_BLOCKS), 1)


def _combine_group(y_flat, keep, src, order, wts, dt):
    """Each token's K slot outputs, weighted, summed in slot order (no
    scatter-add, so the sum's order is fixed): each (token, slot) read
    from its place in the sorted order, a block of tokens at a time."""
    T, K = wts.shape
    D = y_flat.shape[1]
    at = torch.empty_like(order)
    at[order] = torch.arange(T * K, device=order.device)
    at = at.reshape(T, K)
    kept, rows, w = keep[at], src[at], wts.to(dt)
    step = _block_rows(T)
    out = y_flat.new_empty((T, D))
    for lo in range(0, T, step):
        blk = None
        for j in range(K):
            term = torch.where(kept[lo:lo + step, j, None],
                               y_flat[rows[lo:lo + step, j]], 0.0) \
                * w[lo:lo + step, j, None]
            blk = term if blk is None else blk + term
        out[lo:lo + step] = blk
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


def _group_layout(ctx, G: int, x):
    """How the ``G`` dispatch groups lie on the DTensor ``x``'s mesh:
    (per mesh dimension, "batch" where the groups are split over it and
    None where each of its ranks holds the same ones; the mesh dimensions
    over which the capacity rows of one group are split).  The groups
    take the axes of the ``act_batch`` rule, which ``_dp_groups`` counts;
    where the rows did not divide into them, every rank holds the one
    group, and its expert products are split over those axes by capacity
    row (work XLA splits across a replicated operand: each rank
    multiplies its own rows, and the weights' gradients come back as
    each rank's part of a sum)."""
    rule = ctx.profile.rules.get("act_batch") if ctx.profile else None
    axes = (rule,) if isinstance(rule, str) else tuple(rule or ())
    names = x.device_mesh.mesh_dim_names
    if G > 1:
        return ["batch" if n in axes else None for n in names], ()
    return [None] * len(names), tuple(
        i for i, n in enumerate(names)
        if n in axes and x.device_mesh.size(i) > 1)


def _settle_in_place(y):
    """The DTensor ``y``'s pending sums settled in its own buffer where no
    gradient is taken (a prefill's or a decode's expert outputs): a
    ``redistribute`` holds the partial sums and their total at once, two
    of the dispatch's largest buffers.  ``y`` as it is anywhere else."""
    pend = [pl for pl in y.placements if pl.is_partial()] \
        if isinstance(y, DTensor) and not y.requires_grad else []
    if not pend or any(pl.reduce_op != "sum" for pl in pend):
        return y
    mesh, local = y.device_mesh, y.to_local()
    ops = torch.ops._c10d_functional
    for i, pl in enumerate(y.placements):
        if pl.is_partial():
            ops.wait_tensor(ops.all_reduce_(local, "sum",
                                            mesh.get_group(i).group_name))
    return DTensor.from_local(
        local, mesh, [Replicate() if pl.is_partial() else pl
                      for pl in y.placements],
        run_check=False, shape=y.shape, stride=y.stride())


def _dropping_dispatch(x, p, prefix, cfg, top_w, top_ids, ctx):
    """GShard capacity dispatch, group-local: the batch splits into the
    ``_dp_groups(ctx)`` data-parallel groups (one where B does not divide),
    each group's T/G tokens are sorted into their own buffers of capacity
    ``ceil(T/G·K/E·capacity_factor)`` per expert, the slots past it dropped
    (their tokens keep the other experts' and the shared output).  The
    expert products run once over every group's buffers, laid out by
    expert (E, G, cap, D).  On a DTensor each rank sorts and combines its
    own groups' tokens (``to_shard``) and the buffers are sharded on G
    (``from_shard``), as ``repro``'s vmapped dispatch is shard-local."""
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
    split = ()
    if isinstance(xg, DTensor):  # this rank's groups, as plain tensors
        mesh, dims = xg.device_mesh, {"batch": 0}
        roles, split = _group_layout(ctx, G, xg)
        xg, idsg, wtsg = (to_shard(t, mesh, roles, dims)
                          for t in (xg, idsg, wtsg))
    groups = [_scatter_group(xg[g], idsg[g], E, K, cap, dt)
              for g in range(xg.shape[0])]
    # the buffers by expert, every group's beside the others' (E, G, cap,
    # D); one group's is its scatter buffer itself
    buf = torch.stack([gr[0] for gr in groups], dim=1) if len(groups) > 1 \
        else groups[0][0][:, None]
    groups = [gr[1:] for gr in groups]
    if isinstance(x, DTensor):
        buf = from_shard(buf, mesh, roles, {"batch": 1}, (E, G, cap, D))
        buf = buf.redistribute(mesh, [Shard(2) if i in split else pl for
                                      i, pl in enumerate(buf.placements)])
    buf = ctx.constrain(buf, (None, "act_batch", None, None), split)
    wg, wu, wd = (p[f"{prefix}{n}"].to(dt)
                  for n in ("we_gate", "we_up", "we_down"))
    # each buffer let go once read: a prefill's dispatch holds no two of
    # them at once
    be = buf.reshape(E, G * cap, D)
    del buf
    h = F.silu(torch.bmm(be, wg)) * torch.bmm(be, wu)
    del be
    h = ctx.constrain(h.reshape(E, G, cap, -1),
                      (None, "act_batch", None, "act_ff"), split)
    y = _settle_in_place(torch.bmm(h.reshape(E, G * cap, -1), wd))
    del h
    y = ctx.constrain(y.reshape(E, G, cap, D),
                      (None, "act_batch", None, None), split)
    if isinstance(x, DTensor):
        y = to_shard(y, mesh, roles, {"batch": 1})
    out = [_combine_group(y[:, g].reshape(E * cap, D), keep, src, order,
                          wtsg[g], dt)
           for g, (keep, src, order) in enumerate(groups)]
    out = torch.stack(out) if len(out) > 1 else out[0][None]
    if isinstance(x, DTensor):
        out = from_shard(out, mesh, roles, dims, (G, t_loc, D))
    out = ctx.constrain(out, ("act_batch", None, None))
    return out.reshape(B, S, D)
