"""Shared model machinery: parameter tables, norms, RoPE, blockwise attention.

The port's counterpart of ``repro.models.common``.  Parameters are a flat
``dict[str, torch.Tensor]``.  Each model family builds a ``param_table`` —
``dict[name, ParamSpec]`` — from which init and the shapes derive.
Layer-stacked params carry a leading "layers" axis and are consumed by a
Python loop over layers (``repro`` scans them).

Attention is blockwise (flash-style online softmax over KV chunks, inside
an outer loop over query chunks) in plain PyTorch ops that follow
``repro``'s step by step: ``repro`` keeps it in plain ``jnp`` (no Pallas
kernel), so there is no kernel to port.  ``repro``'s sharding context
(``ctx``, a ``distributed.sharding.ShardingCtx``) is threaded through in
its positions; its ``constrain`` never changes a value.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset,
)
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (
    NULL_CTX,
    ShardingCtx,
    resolve_axes,
)

Params = Dict[str, torch.Tensor]
NEG_INF = -1e30

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[name]


def acc_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype ``repro`` accumulates in, float32, or ``dt`` where that is
    wider (a float64 model stays float64 throughout)."""
    return torch.promote_types(dt, torch.float32)


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, allocating nothing (``repro``'s
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names (len == rank)
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # stddev override; default 1/sqrt(fan_in)
    dtype: Optional[str] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_param(generator: torch.Generator, spec: ParamSpec, dtype: str,
               device=None) -> torch.Tensor:
    """One parameter drawn from ``generator`` on ``device`` (default: the
    generator's).  ``fan_in`` is ``shape[-2]`` for rank ≥ 2, as in
    ``repro``: for ``wq`` at ``(L, d, H, hd)`` that is H."""
    dt = torch_dtype(spec.dtype or dtype)
    device = generator.device if device is None else device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale if spec.scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
    # scaled in place: one float32 tensor of the shape at a time
    return torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                       device=device).mul_(float(std)).to(dt)


def init_params(table: Dict[str, ParamSpec], generator: torch.Generator,
                dtype: str, device=None) -> Params:
    """Every parameter of ``table``, drawn in sorted name order."""
    return {n: init_param(generator, table[n], dtype, device)
            for n in sorted(table)}


def param_shape_structs(table: Dict[str, ParamSpec],
                        dtype) -> Dict[str, TensorSpec]:
    """Every parameter's ``TensorSpec``: its shape, in its own dtype or
    ``dtype``."""
    return {n: TensorSpec(tuple(s.shape), torch_dtype(s.dtype or dtype))
            for n, s in table.items()}


def count_params(table: Dict[str, ParamSpec]) -> int:
    return sum(int(np.prod(s.shape)) for s in table.values())


class FlatParamsLM(nn.Module):
    """A model over a flat parameter dict.  Holds no tensors: ``init``
    returns the dict, and ``forward`` (``loss``), ``prefill`` and
    ``decode`` take one.  A family names in ``KEEP`` the weights that
    ``repro`` reads in float32 (norms, decay and step parameters):
    ``compute_params`` leaves those as they are, since cast to bf16 and
    back they would carry bits ``repro`` never sees."""

    KEEP: Tuple[str, ...] = ()

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg

    def param_table(self) -> Dict[str, ParamSpec]:
        raise NotImplementedError

    def param_specs(self) -> Dict[str, TensorSpec]:
        """The parameters' ``TensorSpec``s in ``param_dtype``, allocating
        nothing."""
        return param_shape_structs(self.param_table(), self.cfg.param_dtype)

    def init(self, generator: torch.Generator, device=None) -> Params:
        """Random parameters from ``generator`` (on its device unless
        ``device`` is given), in ``param_dtype``."""
        return init_params(self.param_table(), generator, self.cfg.param_dtype,
                           device)

    def compute_params(self, params: Params) -> Params:
        """The parameters as every use reads them: cast once to the compute
        dtype (``repro`` casts at every use, which gives the same bits),
        ``KEEP`` left as they are.  The same tensors when they already
        are."""
        dt = torch_dtype(self.cfg.compute_dtype)
        return {n: p if n in self.KEEP else p.to(dt)
                for n, p in params.items()}

    def init_compute(self, generator: torch.Generator, device=None) -> Params:
        """``compute_params(init(generator))``, bit for bit, without the
        parameters: each tensor is drawn as ``init`` draws it (same
        generator, sorted name order) and cast at once, so at most one
        parameter-dtype tensor is alive at a time."""
        cfg = self.cfg
        dt = torch_dtype(cfg.compute_dtype)
        table = self.param_table()
        out = {}
        for n in sorted(table):
            p = init_param(generator, table[n], cfg.param_dtype, device)
            out[n] = p if n in self.KEEP else p.to(dt)
            del p  # before the next draw, not after it
        return out


def remat(cfg, fn, *args):
    """``fn(*args)``; with ``cfg.remat`` set and autograd recording, its
    activations are recomputed in the backward pass instead of kept
    (``repro`` wraps the same layer bodies in ``jax.checkpoint``).  Rows
    that fell back to replicated over the row axes reach it folded into
    the sequence (``fold_rows``): it holds each rank's own positions."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def scalar_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: multiplying a
    tensor of that dtype by it rounds as a product of two ``dtype`` values
    does (``repro`` casts the scalar first), and it makes no device tensor,
    whose host-to-device copy would wait for the card."""
    return float(torch.tensor(value, dtype=dtype))


# the most bytes of the accumulation dtype that ``rms_norm`` works on at a
# time in a rank's piece of a DTensor where it needs no gradient
NORM_CHUNK_BYTES = 1 << 28


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm of the last dimension, computed in the accumulation dtype.
    Without a gradient, a (…, S, d) DTensor whose rank's piece in that
    dtype would pass ``NORM_CHUNK_BYTES`` is normed in runs of positions
    of one length (``norm_runs``): no copy of the whole piece in the
    accumulation dtype (a prefill's (B, S, d) activations are several GB
    of it).  A plain tensor is normed whole."""
    dt, at = x.dtype, acc_dtype(x.dtype)
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                           else p for p in x.placements])
    if isinstance(x, DTensor) and x.dim() >= 2 and not (
            torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
            or any(p.is_shard(x.dim() - 2) for p in x.placements)):
        # the positions are whole on every rank: runs of the largest
        # length that divides them and keeps a run within the bytes
        S = x.shape[-2]
        cap = NORM_CHUNK_BYTES * S // max(
            1, x.to_local().numel() * torch.finfo(at).bits // 8)
        step = next(n for n in range(max(1, min(cap, S)), 0, -1)
                    if S % n == 0)
        if step < S:
            return norm_runs(x, w, eps, step)
    xf = x.to(at)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.to(at))).to(dt)


def norm_runs(x: torch.Tensor, w: torch.Tensor, eps: float,
              step: int) -> torch.Tensor:
    """``rms_norm``'s formula a run of ``step`` positions (dimension -2,
    which ``step`` divides) at a time, each written into one output laid
    out as ``x``: every run is the same operations on the same number of
    rows, each row's as the whole input's."""
    at = acc_dtype(x.dtype)
    out = batch_local(torch.empty_like, x)
    scale = 1.0 + w.to(at)
    for r in range(0, x.shape[-2], step):
        xf = x.narrow(-2, r, step).to(at)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        out.narrow(-2, r, step).copy_((y * scale).to(x.dtype))
    return out


def rope_freqs(head_dim: int, theta: float, device=None,
               dtype=torch.float32) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=dtype,
                               device=device) / head_dim)
    )


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int32."""
    d = x.shape[-1]
    at = acc_dtype(x.dtype)
    freqs = rope_freqs(d, theta, device=x.device, dtype=at)  # (D/2,)
    ang = positions[..., None].to(at) * freqs  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(at), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def glu_mlp(x, w_gate, w_up, w_down, act: str,
            ctx: ShardingCtx = NULL_CTX):
    h_g = x @ w_gate.to(x.dtype)
    h_u = x @ w_up.to(x.dtype)
    if act == "swiglu":
        h = F.silu(h_g) * h_u
    elif act == "geglu":
        h = F.gelu(h_g, approximate="tanh") * h_u
    else:
        raise ValueError(act)
    h = ctx.constrain(h, ("act_batch", None, "act_ff"))
    return h @ w_down.to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise attention (online softmax over KV chunks)
# ---------------------------------------------------------------------------

def _pad_seq(x: torch.Tensor, pad: int, value=0) -> torch.Tensor:
    """Pad axis 1 of ``x`` with ``pad`` trailing entries of ``value``."""
    widths = [0, 0] * (x.dim() - 2) + [0, pad]
    return F.pad(x, widths, value=value)


def batch_local(like, ref: torch.Tensor, *args, **kw) -> torch.Tensor:
    """``like(ref, *args)`` (``torch.zeros_like`` / ``full_like``) as a
    new contiguous tensor of ``ref``'s shape and dtype: a loop's carried
    state (or a mask) built from the sharded input it meets, so a DTensor
    ``ref``'s placements carry over.  A plain factory at the global shape
    is replicated, and mixing it with batch-sharded operands gathers them
    to the global batch.  On a plain tensor, ``torch.zeros`` /
    ``torch.full`` at ``ref``'s shape, bit for bit."""
    return like(ref, *args, memory_format=torch.contiguous_format, **kw)


class DecodeRows:
    """A decode step's token rows (B, 1, d) held on their batch shards and
    whole on "model" after every residual add (``hold``), with the
    tensor-parallel weights' FSDP shards gathered (``weights``): each
    product then moves nothing, where left to DTensor a product with a
    weight sharded on its rows gathers the token's rows and all-reduces
    its partial sums at the whole batch.  Where the profile leaves the
    rows whole (a long cell's batch of one) both do nothing: DTensor's own
    products move less there."""

    AXES = ("act_batch", None, "act_embed")

    def __init__(self, ctx: ShardingCtx, x):
        self.ctx = ctx
        self.on = (ctx.mesh is not None and ctx.profile is not None
                   and isinstance(x, DTensor) and resolve_axes(
                       ctx.mesh, self.AXES, x.shape, ctx.profile)[0]
                   is not None)

    def hold(self, x):
        return self.ctx.constrain(x, self.AXES) if self.on else x

    def weights(self, params, dtype, keep, rows_first=()):
        """The layer's weights for a decode step: the tensor-parallel ones'
        FSDP shards gathered (cast to ``dtype`` but for ``keep``), but for
        those named in ``rows_first``, left on their shards for
        ``times``."""
        if not self.on:
            return params
        return {**self.ctx.gather_fsdp(
            {k: w for k, w in params.items() if k not in rows_first},
            dtype, keep, tp_only=True),
            **{k: params[k] for k in params if k in rows_first}}

    def spread(self, x):
        """The rows ``x`` (B, S, d) whole and their columns sharded as the
        weights' rows are (FSDP's axes: the profile's "embed" rule): every
        product with a weight whose rows are so sharded is then each
        rank's block, summed (``rows_times``), and the elementwise work
        between them (a token-shift lerp) moves nothing."""
        if not self.on:
            return x
        rule = self.ctx.profile.rules.get("embed")
        axes = (rule,) if isinstance(rule, str) else tuple(rule or ())
        mesh = x.device_mesh
        return x.redistribute(mesh, [
            Shard(x.ndim - 1) if n in axes else
            Replicate() if p.is_shard(0) else p
            for n, p in zip(mesh.mesh_dim_names, x.placements)])

    def times(self, x, *ws) -> list:
        """``[x @ w for w in ws]``; on a decode step's rows, each product
        moves the rows where they are fewer bytes than the weight's block
        (``rows_times``: the rows gathered once for all of ``ws``), else
        the weight's FSDP shards (gathered as ``weights`` gathers them)."""
        if not self.on or torch.is_grad_enabled() and (
                x.requires_grad or any(w.requires_grad for w in ws)):
            return [x @ w for w in ws]
        # columns "model" does not shard (a LoRA's, a state's): each rank
        # makes its block, gathered back to the layout ``x @ w`` gives
        cut = split_dims(self.ctx, "act_ff")
        out = []
        for o, w in zip(rows_times(x, ws, cut), ws):
            if o is None:
                o = x @ self.ctx.gather_fsdp(w, tp_only=True)
            elif any(o.placements[i].is_shard() and w.placements[i]
                     .is_replicate() for i in cut):
                o = o.redistribute(o.device_mesh, [
                    Replicate() if i in cut and w.placements[i].is_replicate()
                    else p for i, p in enumerate(o.placements)])
            out.append(o)
        return out


# the rows of no decode step: every method of it leaves its input as it is
# and ``times`` is the plain product
NO_ROWS = DecodeRows(NULL_CTX, None)


def new_layers_like(cache: torch.Tensor) -> torch.Tensor:
    """An empty buffer for a decode step's new (L, …) cache entry, laid
    out as the old one (``batch_local``): each layer writes its own entry
    into it as it makes it, so the layers' entries are never all alive
    beside their stack (``torch.stack`` of a list holds both)."""
    return batch_local(torch.empty_like, cache)


def positions_like(x: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """(B, S) positions 0 … S-1 of a (B, S, …) tensor, laid out as its
    first two dimensions are (``batch_local``)."""
    while x.dim() > 2:
        x = x[..., 0]
    return batch_local(torch.zeros_like, x, dtype=dtype) \
        + torch.arange(x.shape[1], dtype=dtype, device=x.device)


# Attention and the chunked scans work on each (row, head) alone.  On a
# DTensor sharded only over its rows and heads they run on each rank's own
# shards, as GSPMD partitions them: DTensor's products flatten the row and
# head dimensions into one batch dimension, and where both are sharded it
# gathers one of them to the whole (the rows, on torch 2.11).

def shard_roles(ref, head_dim: int):
    """Per mesh dimension of the DTensor ``ref``: "batch" where it shards
    dimension 0, "heads" where it shards ``head_dim`` (heads, or the
    channels of a per-channel op), None where it is replicated; None for
    any other layout (another dimension sharded, a pending sum), which the
    caller leaves to DTensor."""
    roles = []
    for p in ref.placements:
        if p.is_replicate():
            roles.append(None)
        elif type(p) is Shard and p.dim in (0, head_dim):
            roles.append("batch" if p.dim == 0 else "heads")
        else:
            return None
    return roles


def _role_placements(roles, dims):
    return [Shard(dims[r]) if dims.get(r) is not None else Replicate()
            for r in roles]


def to_shard(t, mesh, roles, dims) -> torch.Tensor:
    """This rank's piece of ``t`` with each mesh dimension's role mapped by
    ``dims`` to the dimension of ``t`` it shards (replicated where ``dims``
    maps none; a plain tensor is taken as replicated).  Where ``t`` is
    replicated but the work is split, each rank's gradient is a part of the
    whole: it comes back as a pending sum."""
    pl = _role_placements(roles, dims)
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    t = t.redistribute(mesh, pl)
    return t.to_local(grad_placements=[
        Partial() if r is not None and p.is_replicate() else p
        for r, p in zip(roles, pl)])


def from_shard(local, mesh, roles, dims, shape) -> DTensor:
    """The DTensor of global ``shape`` whose rank's piece is ``local`` (made
    contiguous, as the DTensor's strides say), laid out as ``to_shard``
    lays out its inputs."""
    return _from_rows(local.contiguous(), mesh, _role_placements(roles, dims),
                      shape)


def fold_rows(t, dims) -> DTensor:
    """The (B, S, …) DTensor ``t``, replicated over the mesh dimensions
    ``dims`` (``ShardingCtx.sequence_fold``), as (k·B, S/k, …) rows
    sharded over them (k their rank count): each rank's rows are its own
    contiguous S/k positions of every row, taken where it lies (no bytes
    move; the gradient's way back gathers them).  Row j·B + b of a shard
    over the rows' other mesh dimensions is row b's j-th piece
    (``_unfold_rows``)."""
    mesh = t.device_mesh
    piece = t.redistribute(mesh, [Shard(1) if i in dims else p
                                  for i, p in enumerate(t.placements)])
    k = int(np.prod([mesh.size(i) for i in dims]))
    B, S = t.shape[:2]
    return _from_rows(piece.to_local(), mesh,
                      [Shard(0) if i in dims else p
                       for i, p in enumerate(t.placements)],
                      (k * B, S // k) + tuple(t.shape[2:]))


def _unfold_rows(t: torch.Tensor, k: int) -> torch.Tensor:
    """The (k·B, S/k, …) rows of ``fold_rows`` gathered, as the (B, S, …)
    rows they were."""
    kb, s = t.shape[:2]
    t = t.reshape(k, kb // k, s, *t.shape[2:]).transpose(0, 1)
    return t.reshape(kb // k, k * s, *t.shape[3:])


def split_dims(ctx: ShardingCtx, logical: str, *ts) -> Tuple[int, ...]:
    """The mesh dimensions of the activation axis ``logical``'s rule over
    which every one of the DTensors ``ts`` is replicated: where the
    dimension the rule shards did not divide and fell back, the work that
    ``column_split`` / ``row_split`` split by hand.  () off a mesh."""
    if ctx.mesh is None or ctx.profile is None or not all(
            isinstance(t, DTensor) for t in ts):
        return ()
    rule = ctx.profile.rules.get(logical)
    axes = (rule,) if isinstance(rule, str) else tuple(rule or ())
    return tuple(i for i, n in enumerate(ctx.mesh.mesh_dim_names)
                 if n in axes and all(t.placements[i].is_replicate()
                                      for t in ts))


def own_part(w: DTensor, dim: int, lo: int, n: int) -> torch.Tensor:
    """Positions ``[lo, lo + n)`` of dimension ``dim`` of the replicated
    DTensor ``w``, as a local tensor; its gradient (zero elsewhere) is each
    rank's part of a pending sum."""
    return w.to_local(grad_placements=[Partial()] * w.device_mesh.ndim) \
        .narrow(dim, lo, n)


def column_split(x, w, dims, bias=None) -> Optional[DTensor]:
    """``x @ w (+ bias)`` for a replicated weight ``w`` of shape (d, N, …)
    whose N the mesh dimensions ``dims`` do not divide, with ``x``
    replicated over them: each rank multiplies its rows by its own block
    of N (the block an uneven ``Shard`` gives, ⌈N / k⌉ or fewer) and adds
    its block of the replicated ``bias`` (N, …), and the (…, N, …) result
    is sharded on N over ``dims`` (work GSPMD splits across a replicated
    operand; the port's DTensor would do it whole on every rank).  The
    gradients of ``x``, ``w`` and ``bias`` are each rank's part, pending
    sums over ``dims``.  None where ``w`` is not replicated on every mesh
    dimension or ``x`` is a pending sum."""
    mesh = w.device_mesh
    if not all(p.is_replicate() for p in w.placements) or any(
            p.is_partial() for p in x.placements):
        return None
    shape, off = compute_local_shape_and_global_offset(
        w.shape, mesh, [Shard(1) if i in dims else Replicate()
                        for i in range(mesh.ndim)])
    wl = own_part(w, 1, off[1], shape[1])
    xl = x.to_local(grad_placements=[Partial() if i in dims else p
                                     for i, p in enumerate(x.placements)])
    out = (xl @ wl.reshape(wl.shape[0], -1)).reshape(
        *xl.shape[:-1], *wl.shape[1:])
    if bias is not None:
        out = out + own_part(bias, 0, off[1], shape[1])
    return _from_rows(out, mesh, [Shard(x.ndim - 1) if i in dims else p
                                  for i, p in enumerate(x.placements)],
                      tuple(x.shape[:-1]) + tuple(w.shape[1:]))


def cut_columns(x, w, ctx: ShardingCtx, logical: str = "heads"):
    """``x @ w`` for a decode step's rows and a weight (d, n) whose columns
    every rank of the mesh dimensions of ``logical``'s rule holds whole
    (KV heads the rule does not shard): each rank takes its own block of
    the columns where it lies, gathers that block's FSDP shards, makes
    only those columns of its rows, and the blocks are gathered back to
    the layout ``x @ w`` gives (a decode step's few rows: GSPMD splits
    this work too).  ``x @ w`` itself where that does not apply, the rows
    are whole (a long cell's batch of one, where DTensor's own product
    moves less) or a gradient is recorded."""
    dims = split_dims(ctx, logical, w) if isinstance(w, DTensor) and \
        isinstance(x, DTensor) and any(p.is_shard(0) for p in x.placements) \
        and not (torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad)) else ()
    if not dims or any(p.is_shard(1) for p in w.placements) or not all(
            x.placements[i].is_replicate() or x.placements[i].is_partial()
            or x.placements[i].is_shard(x.ndim - 1) for i in dims):
        return x @ w
    mesh = w.device_mesh
    # rows cut or pending over these dimensions are made whole there (a
    # few rows' bytes)
    x = x.redistribute(mesh, [Replicate() if i in dims else p
                              for i, p in enumerate(x.placements)])
    pl = [Shard(1) if i in dims else p for i, p in enumerate(w.placements)]
    shape, off = compute_local_shape_and_global_offset(w.shape, mesh, pl)
    block = _from_rows(w.to_local().narrow(1, off[1], shape[1]), mesh, pl,
                       tuple(w.shape))
    # the block's FSDP shards gathered: each rank's rows meet its whole
    # block, as a tensor-parallel weight gathered at use
    out = x @ block.redistribute(mesh, [Replicate() if p.is_shard(0) else p
                                        for p in pl])
    return out.redistribute(mesh, [Replicate() if i in dims else p
                                   for i, p in enumerate(out.placements)])


def row_split(a, w, dims) -> Optional[DTensor]:
    """``a.flatten(-2) @ w.flatten(0, 1)`` for ``a`` (…, N, h) sharded on
    N over the mesh dimensions ``dims`` (``column_split``'s output) and a
    replicated ``w`` of shape (N, h, d): each rank contracts its own block
    of N, and the (…, d) result is a pending sum over ``dims`` (tensor
    parallelism's output projection).  None where the layouts differ."""
    mesh = w.device_mesh
    nd = a.ndim - 2
    if not dims or not all(p.is_replicate() for p in w.placements) or any(
            a.placements[i] != Shard(nd) for i in dims) or any(
            p.is_partial() or p.is_shard(nd)
            for i, p in enumerate(a.placements) if i not in dims):
        return None
    _, off = compute_local_shape_and_global_offset(a.shape, mesh,
                                                    a.placements)
    al = a.to_local()
    wl = own_part(w, 0, off[nd], al.shape[nd])
    out = al.flatten(-2) @ wl.reshape(-1, wl.shape[-1])
    return _from_rows(out, mesh, [Partial() if i in dims else p
                                  for i, p in enumerate(a.placements)],
                      tuple(a.shape[:-2]) + (w.shape[-1],))


class LocalKV:
    """The keys and values of a loss path's attention that every rank of
    the query heads' mesh dimensions would make whole: ``make(lo, hi)``
    gives this rank's K and V of KV heads ``[lo, hi)`` for its own rows,
    as local tensors; attention asks for the ones its query heads read
    (``_attention_shards``)."""

    def __init__(self, num_heads: int, make):
        self.num_heads = num_heads
        self.make = make


def _attention_shards(q, k, v, pos_q, pos_k, fold=()):
    """(q, k, v, pos_q, pos_k, wrap) as this rank's pieces when the queries
    are a DTensor sharded only over their rows and heads: the keys, values
    and positions on the same rows, K / V cut to the heads this rank's
    queries read (GQA: a whole group, or the one KV head of a part of a
    group); ``wrap`` makes the output a DTensor laid out as the queries.
    Rows folded over the mesh dimensions ``fold`` (``fold_rows``) attend
    to their whole rows: the keys, values and their positions gathered
    over them and unfolded, each rank's queries at their own positions.
    None for any other layout."""
    roles = shard_roles(q, 2)
    if roles is None:
        return None
    roles = ["fold" if i in fold and r == "batch" else r
             for i, r in enumerate(roles)]
    mesh = q.device_mesh
    local_kv = isinstance(k, LocalKV)
    G = q.shape[2] // (k.num_heads if local_kv else k.shape[2])
    _, off = compute_local_shape_and_global_offset(q.shape, mesh,
                                                    q.placements)
    ql = q.to_local()
    n, h0 = ql.shape[2], off[2]
    pql = to_shard(pos_q, mesh, roles, {"batch": 0, "fold": 0})
    pkl = to_shard(pos_k, mesh, roles, {"batch": 0})

    def wrap(out):
        return from_shard(out, mesh, roles,
                          {"batch": 0, "fold": 0, "heads": 2},
                          tuple(q.shape))

    if local_kv:  # each query head meets its own KV head, made here
        lo = h0 // G
        kl, vl = k.make(lo, (h0 + n - 1) // G + 1 if n else lo)
        idx = torch.div(torch.arange(h0, h0 + n, device=ql.device), G,
                        rounding_mode="floor") - lo
        return ql, kl[:, :, idx], vl[:, :, idx], pql, pkl, wrap
    kv_sharded = isinstance(k, DTensor) and "heads" in roles and all(
        k.placements[i] == Shard(2) for i, r in enumerate(roles)
        if r == "heads")
    if kv_sharded and n % G == 0 and h0 % G == 0:
        kv, kdims = slice(None), {"batch": 0, "heads": 2}
    elif n % G == 0 and h0 % G == 0:
        kv, kdims = slice(h0 // G, h0 // G + n // G), {"batch": 0}
    elif G % n == 0 and h0 % n == 0:
        kv, kdims = slice(h0 // G, h0 // G + 1), {"batch": 0}
    else:  # a block of heads across groups (an uneven split): each query
        # head meets its own KV head
        kv = torch.div(torch.arange(h0, h0 + n, device=ql.device), G,
                       rounding_mode="floor")
        kdims = {"batch": 0}
    kl, vl = (to_shard(t, mesh, roles, kdims)[:, :, kv] for t in (k, v))
    if "fold" in roles:
        n_fold = int(np.prod([mesh.size(i) for i, r in enumerate(roles)
                              if r == "fold"]))
        kl, vl, pkl = (_unfold_rows(t, n_fold) for t in (kl, vl, pkl))
    return ql, kl, vl, pql, pkl, wrap


def blockwise_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    pos_q: torch.Tensor,  # (B, Sq) int32
    pos_k: torch.Tensor,  # (B, Sk) int32; -1 marks an empty cache slot
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 1024,
    q_chunk: Optional[int] = 512,
    fold: Tuple[int, ...] = (),
) -> torch.Tensor:
    """GQA/MQA blockwise attention; returns (B, Sq, Hq, D) in q.dtype.
    Queries that are a DTensor sharded over their rows and heads attend on
    each rank's shards (``_attention_shards``; rows folded over the mesh
    dimensions ``fold`` attend to their whole rows).

    An outer loop over QUERY chunks of ``q_chunk`` (the tail padded with
    ``pos_q = -1``, then sliced off) wraps an inner loop over KV chunks of
    ``chunk`` (a ragged tail padded with ``pos_k = -1``, masked everywhere)
    carrying the online-softmax state, in float32 (float64 for a float64
    model).  A fully masked query row (a pad row) ends as ``repro``'s does:
    the mean of the values.
    """
    local = _attention_shards(q, k, v, pos_q, pos_k, fold) \
        if isinstance(q, DTensor) else None
    if local is None and isinstance(k, LocalKV):
        raise ValueError("LocalKV needs queries sharded on their heads")
    if local is not None:
        *args, wrap = local
        return wrap(blockwise_attention(
            *args, causal=causal, window=window, chunk=chunk,
            q_chunk=q_chunk))
    if q_chunk is not None and q.shape[1] > q_chunk:
        Sq = q.shape[1]
        qc = int(q_chunk)
        pad = (-Sq) % qc
        if pad:
            q = _pad_seq(q, pad)
            pos_q = _pad_seq(pos_q, pad, value=-1)
        outs = [
            blockwise_attention(
                q[:, s:s + qc], k, v, pos_q[:, s:s + qc], pos_k,
                causal=causal, window=window, chunk=chunk, q_chunk=None,
            )
            for s in range(0, q.shape[1], qc)
        ]
        return torch.cat(outs, dim=1)[:, :Sq]
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv if Hkv else 1  # a rank's block of no heads
    scale = float(1.0 / np.sqrt(D))
    chunk = int(min(chunk, Sk))
    if Sk % chunk:  # ragged tail: pad with pos_k = -1 (masked everywhere)
        pad = chunk - Sk % chunk
        k, v = _pad_seq(k, pad), _pad_seq(v, pad)
        pos_k = _pad_seq(pos_k, pad, value=-1)
        Sk += pad

    at = acc_dtype(q.dtype)
    qf = (q.to(at) * scale).reshape(B, Sq, Hkv, G, D)
    # the state is built from qf itself, so a sharded qf's batch (and head)
    # shards carry over: a plain factory at the global shape would be
    # replicated, and the K / V chunks gathered to the global batch to meet it
    acc = batch_local(torch.zeros_like, qf.permute(0, 2, 3, 1, 4))
    m = batch_local(torch.full_like, qf[..., 0].permute(0, 2, 3, 1), NEG_INF)
    l = batch_local(torch.zeros_like, qf[..., 0].permute(0, 2, 3, 1))
    for s0 in range(0, Sk, chunk):
        k_c = k[:, s0:s0 + chunk].to(at)  # (B, c, Hkv, D)
        v_c = v[:, s0:s0 + chunk].to(at)
        pk_c = pos_k[:, s0:s0 + chunk]               # (B, c)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_c)  # (B,Hkv,G,Sq,c)
        mask = pk_c[:, None, :] >= 0  # valid slot
        if causal:
            mask = mask & (pk_c[:, None, :] <= pos_q[:, :, None])
        if window is not None:
            mask = mask & ((pos_q[:, :, None] - pk_c[:, None, :]) < window)
        s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v_c)
        m = m_new

    out = acc / torch.clamp_min(l[..., None], 1e-20)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,      # (B, 1, Hq, D)
    k: torch.Tensor,      # (B, S, Hkv, D)
    v: torch.Tensor,      # (B, S, Hkv, D)
    pos_q: torch.Tensor,  # (B, 1)
    pos_k: torch.Tensor,  # (B, S); -1 marks empty slots
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token attention over the whole cache, no chunk loop.

    The products take operands in the cache's dtype and accumulate in
    float32 (``repro``'s ``preferred_element_type=float32``): the operands
    are cast to float32, which is exact for bf16, so the scores stay fp32.
    The softmax weights are rounded to the cache's dtype before the value
    product, as in ``repro``.  A cache that is a DTensor sharded over its
    rows, sequence and heads attends on each rank's shards
    (``_decode_attention_shards``).
    """
    if isinstance(k, DTensor):
        out = _decode_attention_shards(q, k, v, pos_q, pos_k, window)
        if out is not None:
            return out
    B, _, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    at = acc_dtype(k.dtype)
    qh = (q * scalar_in(1.0 / np.sqrt(D), q.dtype)).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qh.to(k.dtype).to(at), k.to(at))
    mask = (pos_k >= 0) & (pos_k <= pos_q)  # (B, S)
    if window is not None:
        mask = mask & ((pos_q - pos_k) < window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).to(at), v.to(at))
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def _decode_attention_shards(q, k, v, pos_q, pos_k, window):
    """``decode_attention`` on this rank's pieces when the cache ``k`` is a
    DTensor sharded only over its rows (dim 0), sequence (dim 1) and KV
    heads (dim 2): the queries cut to the same rows and to the heads that
    read this rank's KV heads, the output laid out as those cuts and
    replicated over the sequence's mesh dimensions.  Where the sequence is
    whole on every rank it is the plain call on the pieces, bit for bit;
    where it is split, the softmax over it is ``repro``'s: the scores'
    max all-reduced with MAX, the sum of their exponentials and the
    weighted values with SUM over the sequence's mesh dimensions (each
    rank's scores stay its own).  Where the KV heads are whole on every
    rank and a mesh dimension shards neither the cache nor the queries
    (a long cell's "model" axis, which its few KV heads do not divide),
    each of its ranks attends with its own block of query heads, each
    head with the KV head it reads (work GSPMD splits across the
    replicated operands), and the output is sharded on its heads over
    it.  None for any other layout."""
    roles = []
    for p in k.placements:
        if p.is_replicate():
            roles.append(None)
        elif type(p) is Shard and p.dim in (0, 1, 2):
            roles.append(("batch", "seq", "heads")[p.dim])
        else:
            return None
    mesh = k.device_mesh
    Hq, Hkv = q.shape[2], k.shape[2]
    G = Hq // Hkv
    kv = {"batch": 0, "seq": 1, "heads": 2}
    if "heads" not in roles and isinstance(q, DTensor):
        n = 1  # the innermost free dimensions whose ranks divide the heads
        for i in reversed(range(mesh.ndim)):
            if roles[i] is None and q.placements[i].is_replicate() \
                    and mesh.size(i) > 1 and Hq % (n * mesh.size(i)) == 0:
                roles[i], n = "qheads", n * mesh.size(i)
    ql = to_shard(q, mesh, roles, {"batch": 0, "heads": 2, "qheads": 2})
    kl, vl = (to_shard(t, mesh, roles, kv) for t in (k, v))
    pql = to_shard(pos_q, mesh, roles, {"batch": 0})
    pkl = to_shard(pos_k, mesh, roles, {"batch": 0, "seq": 1})
    if "qheads" in roles:  # each query head beside its own KV head
        _, off = compute_local_shape_and_global_offset(
            q.shape, mesh, [Shard(2) if r == "qheads" else Replicate()
                            for r in roles])
        kv_of = torch.div(torch.arange(off[2], off[2] + ql.shape[2],
                                       device=ql.device), G,
                          rounding_mode="floor")
        kl, vl = kl[:, :, kv_of], vl[:, :, kv_of]
    elif ql.shape[2] != kl.shape[2] * G:
        return None
    seq = [i for i, r in enumerate(roles) if r == "seq"]
    if not seq:
        out = decode_attention(ql, kl, vl, pql, pkl, window=window)
    else:
        out = _decode_attention_split(ql, kl, vl, pql, pkl, window, mesh,
                                      seq)
    return from_shard(out, mesh, roles, {"batch": 0, "heads": 2,
                                         "qheads": 2}, tuple(q.shape))


def _decode_attention_split(q, k, v, pos_q, pos_k, window, mesh, seq):
    """``decode_attention`` over a cache whose sequence is split over the
    mesh dimensions ``seq``, on this rank's slice of it: the softmax's max
    and sum and the value product's sum all-reduced over them."""
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    at = acc_dtype(k.dtype)
    qh = (q * scalar_in(1.0 / np.sqrt(D), q.dtype)).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qh.to(k.dtype).to(at), k.to(at))
    mask = (pos_k >= 0) & (pos_k <= pos_q)
    if window is not None:
        mask = mask & ((pos_q - pos_k) < window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    for d in seq:
        m = _all_reduce(m, "max", mesh, d)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    for d in seq:
        l = _all_reduce(l, "sum", mesh, d)
    p = e / l
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).to(at), v.to(at))
    for d in seq:
        out = _all_reduce(out, "sum", mesh, d)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def cache_update(
    cache_k: torch.Tensor,  # (B, S, Hkv, D)
    cache_v: torch.Tensor,
    cache_pos: torch.Tensor,  # (B, S) int32 positions per slot (-1 empty)
    k_new: torch.Tensor,  # (B, 1, Hkv, D)
    v_new: torch.Tensor,
    t: torch.Tensor,  # (B,) int32 current decode position
):
    """Ring-buffer single-token cache update (uniform across archs); returns
    new tensors and leaves the inputs as they were.  The slot is selected
    by a mask laid out as the cache is (``positions_like``): on a cache
    sharded over its batch and sequence each rank writes its own slots,
    where an index write by a global ``arange`` of rows gathers the cache
    whole."""
    S = cache_k.shape[1]
    slot = (t % S).long()  # (B,)
    hit = positions_like(cache_pos, torch.long) == slot[:, None]  # (B, S)
    cache_k = torch.where(hit[..., None, None], k_new.to(cache_k.dtype),
                          cache_k)
    cache_v = torch.where(hit[..., None, None], v_new.to(cache_v.dtype),
                          cache_v)
    cache_pos = torch.where(hit, t[:, None].to(torch.int32), cache_pos)
    return cache_k, cache_v, cache_pos


def _vocab_dims(t, dim: int) -> Tuple[int, ...]:
    """The mesh dimensions that shard dimension ``dim`` (the vocabulary)
    of a DTensor; none for a plain tensor."""
    if not isinstance(t, DTensor):
        return ()
    return tuple(i for i, p in enumerate(t.placements)
                 if p.is_shard(dim % t.ndim))


# the gather and reduce-scatter along one dimension (``*_single`` from
# torch 2.12 on, ``*_tensor`` before it)
_all_gather_dim = getattr(funcol, "all_gather_single", None) \
    or funcol.all_gather_tensor
_reduce_scatter_dim = getattr(funcol, "reduce_scatter_single", None) \
    or funcol.reduce_scatter_tensor


def _wait(t: torch.Tensor) -> torch.Tensor:
    """A functional collective's result, waited for."""
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _all_reduce(t: torch.Tensor, op: str, mesh, dim: int) -> torch.Tensor:
    return _wait(funcol.all_reduce(t, op, (mesh, dim)))


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax at the gold label, on each rank's vocabulary shard
    ``[lo, lo + v)`` of its own rows: the row max all-reduced with MAX and
    the sum of ``exp(lf - max)`` with SUM over the mesh dimensions that
    shard the vocabulary, the gold logit picked where the label falls in
    the shard (zero elsewhere) and all-reduced with SUM.  The backward is
    ``softmax - onehot`` on the shard: no rank holds the whole vocabulary
    or another rank's rows."""

    @staticmethod
    def forward(ctx, lf, labels, lo, mesh, dims):
        m = lf.amax(-1)
        for d in dims:
            m = _all_reduce(m, "max", mesh, d)
        # torch.logsumexp's steps: exp of the shifted logits, summed, then
        # log plus the max (an infinite max adds 0)
        s = torch.sum((lf - m[..., None]).exp_(), dim=-1)
        for d in dims:
            s = _all_reduce(s, "sum", mesh, d)
        lse = torch.log(s) + torch.where(torch.isinf(m), 0.0, m)
        idx = labels.long() - lo
        inside = (idx >= 0) & (idx < lf.shape[-1])
        idx = torch.where(inside, idx, 0)[..., None]
        gold = torch.where(inside, torch.gather(lf, -1, idx)[..., 0], 0.0)
        for d in dims:
            gold = _all_reduce(gold, "sum", mesh, d)
        ctx.save_for_backward(lf, lse, idx, inside)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        lf, lse, idx, inside = ctx.saved_tensors
        grad = g[..., None] * (lf - lse[..., None]).exp()
        gold = torch.where(inside, -g, 0.0)[..., None]
        grad = grad.scatter_add(-1, idx, gold)
        return grad, None, None, None, None


class _VocabParallelEmbed(torch.autograd.Function):
    """The rows of ``tokens`` in a table's vocabulary shard ``[lo, lo +
    v)``, zero for tokens outside it, all-reduced with SUM over the mesh
    dimensions that shard the vocabulary (``dims``; exact: one shard holds
    each row).  The table's shards of its second dimension (FSDP's, over
    ``gather_dims``) are gathered first and its gradient reduce-scattered
    back over those of them that shard the tokens (``split``); over the
    others every rank holds the same tokens and the same gradient, and
    keeps its own columns of it.  The backward accumulates each token's
    gradient into the shard that holds its row: no rank makes the whole
    table."""

    @staticmethod
    def forward(ctx, emb, tokens, lo, mesh, dims, gather_dims, split):
        # the innermost mesh dim first, each gather along the columns of
        # the transposed table (every buffer keeps the shard's rows only)
        for d in reversed(gather_dims):
            emb = _wait(_all_gather_dim(
                emb.t().contiguous(), 0, (mesh, d))).t()
        idx = tokens.long() - lo
        inside = (idx >= 0) & (idx < emb.shape[0])
        idx = torch.where(inside, idx, 0)
        rows = torch.where(inside[..., None], emb[idx], 0.0)
        for d in dims:
            rows = _all_reduce(rows, "sum", mesh, d)
        ctx.save_for_backward(idx, inside)
        ctx.n_rows, ctx.mesh = emb.shape[0], mesh
        ctx.gather_dims, ctx.split = gather_dims, split
        return rows

    @staticmethod
    def backward(ctx, g):
        idx, inside = ctx.saved_tensors
        grad = g.new_zeros((ctx.n_rows, g.shape[-1]))
        grad.index_put_((idx,), torch.where(inside[..., None], g, 0.0),
                        accumulate=True)
        for d in ctx.gather_dims:
            if d in ctx.split:
                grad = _wait(_reduce_scatter_dim(
                    grad.t().contiguous(), "sum", 0, (ctx.mesh, d))).t()
            else:
                n = grad.shape[1] // ctx.mesh.size(d)
                grad = grad[:, ctx.mesh.get_local_rank(d) * n:][:, :n]
        return grad, None, None, None, None, None, None


def _lookup_gathered(emb, tokens, lo, mesh, dims, gather_dims, placements):
    """``_VocabParallelEmbed``'s forward for a table whose columns are
    sharded (FSDP) and fewer tokens than its shard has rows (a decode
    step): the tokens are gathered over the column-sharding mesh
    dimensions that shard them, each rank looks them up in its own block
    of rows and columns, and the rows' columns are gathered: the tokens'
    bytes move, not the table's.  No backward."""
    n_loc, pos = tokens.shape[0], 0
    for d in reversed(gather_dims):  # the innermost mesh dim first
        if placements[d].is_shard(0):
            tokens = _wait(_all_gather_dim(tokens.contiguous(), 0,
                                           (mesh, d)))
    for d in gather_dims:  # this rank's block of the gathered rows
        if placements[d].is_shard(0):
            pos = pos * mesh.size(d) + mesh.get_local_rank(d)
    idx = tokens.long() - lo
    inside = (idx >= 0) & (idx < emb.shape[0])
    rows = torch.where(inside[..., None], emb[torch.where(inside, idx, 0)],
                       0.0)
    for d in dims:
        rows = _all_reduce(rows, "sum", mesh, d)
    for d in reversed(gather_dims):
        rows = _wait(_all_gather_dim(rows.movedim(-1, 0).contiguous(), 0,
                                     (mesh, d))).movedim(0, -1)
    return rows[pos * n_loc:(pos + 1) * n_loc]


def embed_rows(emb: torch.Tensor, tokens):
    """``emb[tokens]``.  With ``emb`` a DTensor sharded on its vocabulary
    (every path: the loss, prefill and decode), the vocab-parallel lookup
    (``_VocabParallelEmbed``), sharded as the tokens' rows are: DTensor's
    own lookup gathers the whole table to every rank, and its backward
    scatters into a whole-table zeros.  The table's second dimension may
    be sharded evenly (FSDP); a mesh dimension that replicates the table
    sums the ranks' gradients.  Without a gradient and with fewer tokens
    than a shard has rows, the tokens are gathered in the table's place
    (``_lookup_gathered``), also where the vocabulary stays whole (one
    the mesh does not divide) but the columns are sharded."""
    tokens = torch.as_tensor(tokens).to(emb.device)
    dims = _vocab_dims(emb, 0)
    gather_dims = tuple(i for i, p in enumerate(emb.placements)
                        if p.is_shard(1)) \
        if isinstance(emb, DTensor) and isinstance(tokens, DTensor) else ()
    if not dims and not gather_dims:
        return emb[tokens.long()]
    mesh = emb.device_mesh
    rows = [Replicate() if i in dims else p
            for i, p in enumerate(tokens.placements)]
    tokens = tokens.redistribute(mesh, rows)
    _, offset = compute_local_shape_and_global_offset(
        emb.shape, mesh, emb.placements)
    # each rank's gradient is its own rows' part of the table's
    local = emb.to_local(grad_placements=[
        Partial() if p.is_replicate() else p for p in emb.placements])
    t_loc = tokens.to_local()
    n_tok = t_loc.numel() * int(np.prod(
        [mesh.size(d) for d in gather_dims if rows[d].is_shard(0)]))
    if gather_dims and n_tok < local.shape[0] and not (
            torch.is_grad_enabled() and emb.requires_grad):
        out = _lookup_gathered(local, t_loc, offset[0], mesh, dims,
                               gather_dims, rows)
    elif not dims:  # many tokens: DTensor's lookup gathers the columns
        return emb[tokens.long()]
    else:
        out = _VocabParallelEmbed.apply(
            local, t_loc, offset[0], mesh, dims, gather_dims,
            tuple(d for d in gather_dims if rows[d].is_shard(0)))
    return _from_rows(out, mesh, rows, tuple(tokens.shape) + emb.shape[1:])


def head_logits(x: torch.Tensor, head: torch.Tensor, ctx=NULL_CTX):
    """``x @ head`` for the LM head (d, V), its FSDP shards gathered first
    (``ShardingCtx.gather_fsdp``), as the loss path needs them.  Without a
    gradient and with fewer rows than a shard of the head has columns (a
    decode step), the rows are gathered in the head's place
    (``rows_times``): the rows' bytes move, not the head's."""
    if isinstance(x, DTensor) and isinstance(head, DTensor) and not (
            torch.is_grad_enabled()
            and (x.requires_grad or head.requires_grad)):
        out = rows_times(x, [head],
                         cut=split_dims(ctx, "act_vocab", head))[0]
        if out is not None:
            return out
    head = ctx.gather_fsdp(head)
    dims = split_dims(ctx, "act_vocab", x, head)
    out = column_split(x, head, dims) if dims else None
    return x @ head if out is None else out


def rows_times(x: DTensor, heads, cut=()) -> list:
    """``[x @ head for head in heads]`` without a gradient, for rows ``x``
    (a DTensor sharded on its rows) and weights (d, n) whose rows are
    FSDP-sharded: each rank multiplies every row the FSDP dimensions hold
    (gathered once for all the weights) by its own block of the weight's
    rows and columns, and the partial sums are reduce-scattered back to
    each rank's rows (all-reduced where the rows are not split), in
    ``x``'s dtype: the rows' bytes move, not the weight's.  Rows already
    spread over their columns as the weight's rows are
    (``DecodeRows.spread``) meet each rank's block with no gather.  Over
    the mesh dimensions ``cut`` where a weight is replicated (a vocabulary
    or a state "model" does not shard), each rank takes its own block of
    its columns, and that result is sharded on them.  An entry is None
    where the layouts do not fit (the rows split on another dimension,
    the weight's rows whole) or the weight moves fewer bytes."""
    mesh = x.device_mesh
    last = x.ndim - 1
    x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                              for p in x.placements])  # a pending sum
    gathered = {}
    outs = []
    for head in heads:
        fsdp = [i for i, p in enumerate(head.placements) if p.is_shard(0)]
        cols = [Shard(1) if i in cut and p.is_replicate() else p
                for i, p in enumerate(head.placements)]
        spread = bool(fsdp) and all(
            x.placements[d].is_shard(last) for d in fsdp) and all(
            p.is_replicate() for i, p in enumerate(x.placements)
            if i not in fsdp)
        if not fsdp or any(not (p.is_replicate() or p.is_shard(0)
                                or p.is_shard(1)) for p in cols) or not (
                spread or all(p.is_replicate() or p.is_shard(0)
                              for p in x.placements) and not any(
                    x.placements[i].is_shard() and cols[i].is_shard(1)
                    for i in range(mesh.ndim))):
            outs.append(None)
            continue
        shape, off = compute_local_shape_and_global_offset(head.shape, mesh,
                                                            cols)
        hl = head.to_local()  # this rank's block of any replicated columns
        hl = hl.narrow(1, off[1], shape[1]) if hl.shape[1] != shape[1] \
            else hl
        if spread:  # each rank's block of rows and columns, no gather
            part = x.to_local() @ hl
            for d in fsdp:
                part = _all_reduce(part, "sum", mesh, d)
            outs.append(_from_rows(
                part, mesh, [Shard(last) if hp.is_shard(1) else Replicate()
                             for hp in cols],
                tuple(x.shape[:-1]) + (head.shape[1],)))
            continue
        split = tuple(d for d in fsdp if x.placements[d].is_shard(0))
        n = x.to_local().shape[0] * int(np.prod([mesh.size(d)
                                                 for d in split]))
        if n * int(np.prod(x.shape[1:last])) >= hl.shape[1]:
            outs.append(None)
            continue
        if split not in gathered:
            xl = x.to_local()
            for d in reversed(split):  # the innermost mesh dim first
                xl = _wait(_all_gather_dim(xl.contiguous(), 0, (mesh, d)))
            gathered[split] = xl
        part = gathered[split][..., off[0]:off[0] + hl.shape[0]] @ hl
        for d in fsdp:
            part = (_wait(_reduce_scatter_dim(part.contiguous(), "sum", 0,
                                              (mesh, d))) if d in split
                    else _all_reduce(part, "sum", mesh, d))
        placements = [Shard(last) if hp.is_shard(1) else xp
                      for xp, hp in zip(x.placements, cols)]
        outs.append(_from_rows(part, mesh, placements,
                               tuple(x.shape[:-1]) + (head.shape[1],)))
    return outs


def _from_rows(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A DTensor of global ``shape`` from this rank's ``local`` piece."""
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _vocab_parallel_nll(lf: DTensor, labels, dims) -> DTensor:
    """Per-position NLL of vocab-sharded logits (a DTensor), as a DTensor
    sharded as the logits' rows are and replicated over the vocabulary's
    mesh dimensions."""
    mesh = lf.device_mesh
    rows = [Replicate() if i in dims else p
            for i, p in enumerate(lf.placements)]
    labels = labels.redistribute(mesh, rows)
    _, offset = compute_local_shape_and_global_offset(
        lf.shape, mesh, lf.placements)
    nll = _VocabParallelNLL.apply(lf.to_local(), labels.to_local(),
                                  offset[-1], mesh, dims)
    return _from_rows(nll, mesh, rows, lf.shape[:-1])


# the most bytes of the accumulation dtype that one row chunk of the
# whole-vocabulary cross entropy works on at a time
CE_CHUNK_BYTES = 1 << 28


def _row_chunks(shape, at: torch.dtype):
    """(batch row, row slice) pairs covering the rows of (B, S, V) logits
    of ``shape`` in chunks of at most ``CE_CHUNK_BYTES`` of ``at`` each:
    each chunk is a contiguous run of a batch row's rows, never a copy of
    the logits."""
    B, S, V = shape
    n = max(1, CE_CHUNK_BYTES // (V * torch.finfo(at).bits // 8))
    for b in range(B):
        for r in range(0, S, n):
            yield b, slice(r, r + n)


class _WholeVocabNLL(torch.autograd.Function):
    """-log softmax at the gold label of (B, S, V) logits over the whole
    vocabulary, each row's reduction as ``torch.logsumexp`` and
    ``torch.gather`` make it on the logits cast to ``at``, without the
    copies autograd keeps of that: the logits are saved in their own dtype
    beside each row's log-sum-exp, the cast and the products run a row
    chunk at a time (``_row_chunks``), and the backward writes ``(softmax -
    onehot) · g`` into one buffer of the logits' dtype, each chunk computed
    in ``at`` and then cast (the rounding of ``at``'s autodiff followed by
    the cast's)."""

    @staticmethod
    def forward(ctx, logits, labels, at):
        idx = labels[..., None].long()
        lse = torch.empty(logits.shape[:-1], dtype=at, device=logits.device)
        gold = torch.empty_like(lse)
        for b, r in _row_chunks(logits.shape, at):
            lc = logits[b, r].to(at)
            lse[b, r] = torch.logsumexp(lc, dim=-1)
            gold[b, r] = torch.gather(lc, -1, idx[b, r])[..., 0]
        ctx.save_for_backward(logits, lse, idx)
        ctx.at = at
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx = ctx.saved_tensors
        grad = torch.empty_like(logits,
                                memory_format=torch.contiguous_format)
        for b, r in _row_chunks(logits.shape, ctx.at):
            gc = g[b, r][..., None]
            pc = gc * (logits[b, r].to(ctx.at) - lse[b, r][..., None]).exp()
            grad[b, r] = pc.scatter_add_(-1, idx[b, r], -gc).to(grad.dtype)
        return grad, None, None


def _whole_vocab_nll(logits, labels, at):
    """Per-position NLL over a vocabulary no mesh dimension shards
    (``_WholeVocabNLL``); on a DTensor, each rank's own rows (its local
    logits and labels), as a DTensor laid out as the logits' rows."""
    if not isinstance(logits, DTensor):
        return _WholeVocabNLL.apply(logits, labels, at)
    mesh = logits.device_mesh
    rows = [Replicate() if p.is_partial() else p for p in logits.placements]
    logits = logits.redistribute(mesh, rows)
    labels = labels.redistribute(mesh, rows)
    nll = _WholeVocabNLL.apply(logits.to_local(), labels.to_local(), at)
    return _from_rows(nll, mesh, rows, logits.shape[:-1])


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean next-token CE in fp32 (float64 for a float64 model); logits
    (B,S,V), labels (B,S).  Logits that are a DTensor sharded on the
    vocabulary (the labels and mask DTensors on its mesh) take the
    vocab-parallel path (``_VocabParallelNLL``), which never gathers the
    vocabulary; others, the whole-vocabulary one (``_WholeVocabNLL``),
    which keeps no float32 copy of them."""
    at = acc_dtype(logits.dtype)
    dims = _vocab_dims(logits, -1)
    if dims:
        nll = _vocab_parallel_nll(logits.to(at), labels, dims)
    else:
        nll = _whole_vocab_nll(logits, labels, at)
    if mask is not None and isinstance(nll, DTensor):
        mask = mask.redistribute(nll.device_mesh, nll.placements)
    if mask is not None:
        mask = mask.to(at)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    if isinstance(nll, DTensor):  # DTensor's mean backward would make
        return torch.sum(nll) / nll.numel()  # every rank's a global one
    return torch.mean(nll)


def next_token_ce(logits: torch.Tensor, labels: torch.Tensor,
                  fold: Tuple[int, ...] = ()) -> torch.Tensor:
    """Mean cross entropy of each position's logits (B, S, V) against the
    next position's label; label -1 is ignored.  Logits of rows folded over
    the mesh dimensions ``fold`` (``fold_rows``) meet the next labels
    folded the same way, the last position masked."""
    if fold:
        mesh = logits.device_mesh
        if not isinstance(labels, DTensor):
            labels = DTensor.from_local(labels, mesh,
                                        [Replicate()] * mesh.ndim,
                                        run_check=False)
        nxt = fold_rows(torch.cat(
            [labels[:, 1:], torch.full_like(labels[:, :1], -1)], dim=1), fold)
        return cross_entropy(logits, torch.clamp_min(nxt, 0),
                             (nxt >= 0).to(torch.float32))
    mask = (labels[:, 1:] >= 0).to(torch.float32)
    return cross_entropy(logits[:, :-1], torch.clamp_min(labels[:, 1:], 0),
                         mask)
