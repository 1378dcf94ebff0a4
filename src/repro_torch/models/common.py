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
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset,
)
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import NULL_CTX, ShardingCtx

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
    (``repro`` wraps the same layer bodies in ``jax.checkpoint``)."""
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


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt, at = x.dtype, acc_dtype(x.dtype)
    xf = x.to(at)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.to(at))).to(dt)


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
) -> torch.Tensor:
    """GQA/MQA blockwise attention; returns (B, Sq, Hq, D) in q.dtype.

    An outer loop over QUERY chunks of ``q_chunk`` (the tail padded with
    ``pos_q = -1``, then sliced off) wraps an inner loop over KV chunks of
    ``chunk`` (a ragged tail padded with ``pos_k = -1``, masked everywhere)
    carrying the online-softmax state, in float32 (float64 for a float64
    model).  A fully masked query row (a pad row) ends as ``repro``'s does:
    the mean of the values.
    """
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
    G = Hq // Hkv
    scale = float(1.0 / np.sqrt(D))
    chunk = int(min(chunk, Sk))
    if Sk % chunk:  # ragged tail: pad with pos_k = -1 (masked everywhere)
        pad = chunk - Sk % chunk
        k, v = _pad_seq(k, pad), _pad_seq(v, pad)
        pos_k = _pad_seq(pos_k, pad, value=-1)
        Sk += pad

    at = acc_dtype(q.dtype)
    qf = (q.to(at) * scale).reshape(B, Sq, Hkv, G, D)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=at, device=q.device)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=at, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=at, device=q.device)
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
    product, as in ``repro``.
    """
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


def cache_update(
    cache_k: torch.Tensor,  # (B, S, Hkv, D)
    cache_v: torch.Tensor,
    cache_pos: torch.Tensor,  # (B, S) int32 positions per slot (-1 empty)
    k_new: torch.Tensor,  # (B, 1, Hkv, D)
    v_new: torch.Tensor,
    t: torch.Tensor,  # (B,) int32 current decode position
):
    """Ring-buffer single-token cache update (uniform across archs); returns
    new tensors and leaves the inputs as they were."""
    S = cache_k.shape[1]
    slot = (t % S).long()  # (B,)
    b_idx = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k = cache_k.index_put((b_idx, slot), k_new[:, 0].to(cache_k.dtype))
    cache_v = cache_v.index_put((b_idx, slot), v_new[:, 0].to(cache_v.dtype))
    cache_pos = cache_pos.index_put((b_idx, slot), t.to(torch.int32))
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
    back.  The backward accumulates each token's gradient into the shard
    that holds its row: no rank makes the whole table."""

    @staticmethod
    def forward(ctx, emb, tokens, lo, mesh, dims, gather_dims):
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
        ctx.n_rows, ctx.mesh, ctx.gather_dims = emb.shape[0], mesh, gather_dims
        return rows

    @staticmethod
    def backward(ctx, g):
        idx, inside = ctx.saved_tensors
        grad = g.new_zeros((ctx.n_rows, g.shape[-1]))
        grad.index_put_((idx,), torch.where(inside[..., None], g, 0.0),
                        accumulate=True)
        for d in ctx.gather_dims:
            grad = _wait(_reduce_scatter_dim(
                grad.t().contiguous(), "sum", 0, (ctx.mesh, d))).t()
        return grad, None, None, None, None, None


def embed_rows(emb: torch.Tensor, tokens, vocab_parallel: bool = False):
    """``emb[tokens]``.  With ``vocab_parallel`` (the loss path) and
    ``emb`` a DTensor sharded on its vocabulary, the vocab-parallel lookup
    (``_VocabParallelEmbed``), sharded as the tokens' rows are: DTensor's
    own lookup gathers the whole table to every rank, and its backward
    scatters into a whole-table zeros.  The table's second dimension may
    be sharded evenly (FSDP); a mesh dimension that replicates the table
    sums the ranks' gradients."""
    tokens = torch.as_tensor(tokens).to(emb.device)
    dims = _vocab_dims(emb, 0) if vocab_parallel else ()
    if not dims:
        return emb[tokens.long()]
    mesh = emb.device_mesh
    gather_dims = tuple(i for i, p in enumerate(emb.placements)
                        if p.is_shard(1))
    rows = [Replicate() if i in dims else p
            for i, p in enumerate(tokens.placements)]
    tokens = tokens.redistribute(mesh, rows)
    _, offset = compute_local_shape_and_global_offset(
        emb.shape, mesh, emb.placements)
    # each rank's gradient is its own rows' part of the table's
    local = emb.to_local(grad_placements=[
        Partial() if p.is_replicate() else p for p in emb.placements])
    out = _VocabParallelEmbed.apply(local, tokens.to_local(), offset[0],
                                    mesh, dims, gather_dims)
    return _from_rows(out, mesh, rows, tuple(tokens.shape) + emb.shape[1:])


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


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean next-token CE in fp32 (float64 for a float64 model); logits
    (B,S,V), labels (B,S).  Logits that are a DTensor sharded on the
    vocabulary (the labels and mask DTensors on its mesh) take the
    vocab-parallel path (``_VocabParallelNLL``), which never gathers the
    vocabulary."""
    at = acc_dtype(logits.dtype)
    lf = logits.to(at)
    dims = _vocab_dims(lf, -1)
    if dims:
        nll = _vocab_parallel_nll(lf, labels, dims)
        if mask is not None:
            mask = mask.redistribute(nll.device_mesh, nll.placements)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
        nll = lse - gold
    if mask is not None:
        mask = mask.to(at)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    if dims:  # DTensor's mean backward would make every rank's a global one
        return torch.sum(nll) / nll.numel()
    return torch.mean(nll)


def next_token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of each position's logits (B, S, V) against the
    next position's label; label -1 is ignored."""
    mask = (labels[:, 1:] >= 0).to(torch.float32)
    return cross_entropy(logits[:, :-1], torch.clamp_min(labels[:, 1:], 0),
                         mask)
