"""Mamba2 / SSD primitives, the zamba2 backbone (counterpart of
``repro.models.ssm``).

The chunked SSD is a Python loop over chunks that carries the SSM state
(``repro`` scans them); inside a chunk it is the masked
(C_i·B_j)·decay(i, j) product of the Mamba-2 paper.  Every decay exponent
is a difference of an inclusive cumsum of ``dt * A <= 0`` along valid
directions, so no ``exp`` argument is positive.  The three-operand
products of ``repro`` are written as pairs in an order fixed here: the
intra-chunk one never forms a (B, Q, Q, nh, hp) tensor, only two
(B, nh, Q, Q).  The depthwise causal conv (k = 4) is ``repro``'s shifted
adds in the same order (``F.conv1d`` sums in another).  Internals run in
float32, float64 for a float64 model (``acc_dtype``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import NULL_CTX, ShardingCtx
from repro_torch.models.common import (
    NO_ROWS,
    ParamSpec,
    _pad_seq,
    acc_dtype,
    batch_local,
    from_shard,
    rms_norm,
    shard_roles,
    to_shard,
)

# the Mamba block's weights ``repro`` reads in float32 (``rms_norm``'s
# weight, the step bias and the decay rate)
MAMBA_KEEP = ("m_norm", "dt_bias", "A_log")


def mamba_param_table(cfg: ModelConfig, lead, lax_) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    dI = cfg.mamba_expand * d
    N = cfg.ssm_state
    nh = dI // cfg.mamba_headdim
    k = cfg.conv_kernel
    return {
        "m_norm": ParamSpec(lead + (d,), lax_ + ("norm",), init="zeros"),
        "wz": ParamSpec(lead + (d, dI), lax_ + ("embed", "ff")),
        "wx": ParamSpec(lead + (d, dI), lax_ + ("embed", "ff")),
        "wB": ParamSpec(lead + (d, N), lax_ + ("embed", "state")),
        "wC": ParamSpec(lead + (d, N), lax_ + ("embed", "state")),
        "wdt": ParamSpec(lead + (d, nh), lax_ + ("embed", "heads")),
        "dt_bias": ParamSpec(lead + (nh,), lax_ + ("heads",), init="zeros"),
        "A_log": ParamSpec(lead + (nh,), lax_ + ("heads",), init="zeros"),
        "D_skip": ParamSpec(lead + (nh,), lax_ + ("heads",), init="ones"),
        "conv_w": ParamSpec(lead + (k, dI), lax_ + ("conv", "ff"), scale=0.5),
        "out_proj": ParamSpec(lead + (dI, d), lax_ + ("ff", "embed")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)).  ``F.softplus`` returns ``x`` itself above its
    threshold of 20, up to 2e-9 away in float64."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C), w: (k, C).  Unrolled shifted-add causal conv: ``x``
    padded once by k - 1 at the front, each tap a slice of it (``repro``
    pads a slice a tap; the products and sums are the same, so are the
    bits, and no slice of a sharded tensor is padded).  On a DTensor
    sharded over its rows and channels each rank convolves its own
    (torch 2.11's DTensor has no strategy for the pad and gathers the
    whole tensor)."""
    roles = shard_roles(x, 2) if isinstance(x, DTensor) else None
    if roles is not None:
        mesh, dims = x.device_mesh, {"batch": 0, "heads": 2}
        return from_shard(causal_depthwise_conv(
            to_shard(x, mesh, roles, dims),
            to_shard(w, mesh, roles, {"heads": 1})), mesh, roles, dims,
            tuple(x.shape))
    k, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = x * w[k - 1]
    for i in range(1, k):
        out = out + xp[:, k - 1 - i:k - 1 - i + S] * w[k - 1 - i]
    return out


def ssd_chunked(
    x: torch.Tensor,   # (B, S, nh, hp)
    dt: torch.Tensor,  # (B, S, nh) positive
    A: torch.Tensor,   # (nh,) negative
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, nh, hp, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, nh, hp) in x's dtype, final state (B, nh, hp, N)
    in float32, or float64 for float64 inputs).  ``x`` a DTensor sharded
    over its rows and heads: each rank scans its own (``shard_roles``)."""
    roles = shard_roles(x, 2) if isinstance(x, DTensor) else None
    if roles is not None:
        mesh, bh, st = x.device_mesh, {"batch": 0, "heads": 2}, \
            {"batch": 0, "heads": 1}
        B, S, nh, hp = x.shape
        N = Bm.shape[-1]
        y, h = ssd_chunked(
            to_shard(x, mesh, roles, bh), to_shard(dt, mesh, roles, bh),
            to_shard(A, mesh, roles, {"heads": 0}),
            *(to_shard(t, mesh, roles, {"batch": 0}) for t in (Bm, Cm)),
            chunk, None if h0 is None else to_shard(h0, mesh, roles, st))
        return (from_shard(y, mesh, roles, bh, (B, S, nh, hp)),
                from_shard(h, mesh, roles, st, (B, nh, hp, N)))
    B, S, nh, hp = x.shape
    N = Bm.shape[-1]
    Q = int(min(chunk, S))
    S_orig = S
    if S % Q:  # ragged tail: dt = 0 padding is a no-op on state and outputs
        pad = Q - S % Q
        x, dt, Bm, Cm = (_pad_seq(a, pad) for a in (x, dt, Bm, Cm))
        S += pad
    at = acc_dtype(x.dtype)
    xf, dtf, Bf, Cf = (a.to(at) for a in (x, dt, Bm, Cm))
    da = dtf * A.to(at)  # (B, S, nh) <= 0
    h = (batch_local(torch.zeros_like,
                     xf[:, 0, :, :, None].expand(B, nh, hp, N))
         if h0 is None else h0)
    past = ~torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()  # i < j
    ys = []
    for c0 in range(0, S, Q):
        x_c, da_c, dt_c, B_c, C_c = (a[:, c0:c0 + Q]
                                     for a in (xf, da, dtf, Bf, Cf))
        cum = torch.cumsum(da_c, dim=1)  # (B, Q, nh) inclusive
        scores = torch.bmm(C_c, B_c.transpose(1, 2))  # (B, Q, Q)
        # (B, nh, Q, Q): the decay exp(cum_i - cum_j) for i >= j, 0 above,
        # then times the scores; two tensors of that size at most
        ct = cum.transpose(1, 2)
        decay = ct[:, :, :, None] - ct[:, :, None, :]
        decay = decay.masked_fill_(past, float("-inf")).exp_()
        w = decay * scores[:, None]
        del decay
        dtx = dt_c[..., None] * x_c  # (B, Q, nh, hp)
        y_intra = torch.matmul(w, dtx.transpose(1, 2)).transpose(1, 2)
        del w
        y_inter = torch.exp(cum)[..., None] * torch.einsum(
            "bin,bhpn->bihp", C_c, h)
        last = cum[:, -1]  # (B, nh)
        kdecay = torch.exp(last[:, None, :] - cum) * dt_c  # (B, Q, nh)
        h = torch.exp(last)[:, :, None, None] * h + torch.einsum(
            "bjhp,bjn->bhpn", kdecay[..., None] * x_c, B_c)
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :S_orig]
    return y.to(x.dtype), h


def ssd_decode_step(
    x: torch.Tensor,   # (B, nh, hp)
    dt: torch.Tensor,  # (B, nh)
    A: torch.Tensor,   # (nh,)
    Bm: torch.Tensor,  # (B, N)
    Cm: torch.Tensor,  # (B, N)
    h: torch.Tensor,   # (B, nh, hp, N) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single token.  A state ``h`` that is a DTensor sharded over its
    rows (and heads) steps on each rank's own, the inputs cut to them
    (``shard_roles``): the state never moves, only the token's inputs."""
    roles = shard_roles(h, 1) if isinstance(h, DTensor) else None
    if roles is not None and "batch" in roles:
        mesh, bh = h.device_mesh, {"batch": 0, "heads": 1}
        y, h_new = ssd_decode_step(
            to_shard(x, mesh, roles, bh), to_shard(dt, mesh, roles, bh),
            to_shard(A, mesh, roles, {"heads": 0}),
            *(to_shard(t, mesh, roles, {"batch": 0}) for t in (Bm, Cm)),
            to_shard(h, mesh, roles, bh))
        return (from_shard(y, mesh, roles, bh, tuple(x.shape)),
                from_shard(h_new, mesh, roles, bh, tuple(h.shape)))
    at = acc_dtype(x.dtype)
    dtf = dt.to(at)
    da = torch.exp(dtf * A.to(at))  # (B, nh)
    xB = (dtf[..., None] * x.to(at))[..., None] * Bm.to(at)[:, None, None, :]
    h_new = da[..., None, None] * h + xB
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm.to(at))
    return y.to(x.dtype), h_new


def mamba_scan_inputs(p, x: torch.Tensor, cfg: ModelConfig,
                      ctx: ShardingCtx = NULL_CTX):
    """The block's input side over a sequence x (B, S, d): returns
    (z, xh, dt, A, Bm, Cm), ``xh`` (B, S, nh, hp) the conv's output by
    head and ``dt``, ``A`` in float32 (float64 for a float64 model)."""
    nh = cfg.mamba_expand * cfg.d_model // cfg.mamba_headdim
    dt_, at = x.dtype, acc_dtype(x.dtype)
    h = rms_norm(x, p["m_norm"], cfg.norm_eps)
    z = h @ p["wz"].to(dt_)
    xin = ctx.constrain(h @ p["wx"].to(dt_), ("act_batch", None, "act_ff"))
    xc = F.silu(causal_depthwise_conv(xin, p["conv_w"].to(dt_)))
    Bm = h @ p["wB"].to(dt_)
    Cm = h @ p["wC"].to(dt_)
    dt = softplus((h @ p["wdt"].to(dt_)).to(at) + p["dt_bias"].to(at))
    A = -torch.exp(p["A_log"].to(at))
    xh = xc.reshape(*xc.shape[:2], nh, cfg.mamba_headdim)
    return z, xh, dt, A, Bm, Cm


def mamba_block_full(p, x: torch.Tensor, cfg: ModelConfig,
                     ctx: ShardingCtx = NULL_CTX, h0=None):
    """Full-sequence Mamba2 block.  x: (B, S, d).  Returns (out,
    final_state)."""
    dt_ = x.dtype
    z, xh, dt, A, Bm, Cm = mamba_scan_inputs(p, x, cfg, ctx)
    y, h_final = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk, h0)
    y = y + p["D_skip"].to(dt_)[None, None, :, None] * xh
    y = y.reshape(*z.shape) * F.silu(z)
    return y @ p["out_proj"].to(dt_), h_final


# the weights whose products a decode step may take with the token's rows
# spread over their columns (``DecodeRows.times``)
MAMBA_ROWS_FIRST = ("wz", "wx", "wB", "wC", "wdt")


def mamba_block_decode(p, x: torch.Tensor, cfg: ModelConfig,
                       conv_state: torch.Tensor, ssm_state: torch.Tensor,
                       ctx: ShardingCtx = NULL_CTX, rows=NO_ROWS):
    """Single-token Mamba2 step.  x: (B, 1, d).

    conv_state: (B, k-1, dI) trailing inputs; ssm_state: (B, nh, hp, N)
    float32.  Returns (out (B, 1, d), conv_state', ssm_state').  With a
    decode step's ``rows`` (``DecodeRows``), the input products take the
    normed rows spread over their columns, as the weights of
    ``MAMBA_ROWS_FIRST`` lie.
    """
    dI = cfg.mamba_expand * cfg.d_model
    nh = dI // cfg.mamba_headdim
    dt_, at = x.dtype, acc_dtype(x.dtype)
    h = rms_norm(x, p["m_norm"], cfg.norm_eps)[:, 0]  # (B, d)
    z, xin, Bm, Cm, dtr = rows.times(
        rows.spread(h), *(p[n].to(dt_) for n in MAMBA_ROWS_FIRST))
    window = torch.cat([conv_state, xin[:, None, :]], dim=1)  # (B, k, dI)
    xc = F.silu(torch.einsum("bkf,kf->bf", window, p["conv_w"].to(dt_)))
    dt = softplus(dtr.to(at) + p["dt_bias"].to(at))
    A = -torch.exp(p["A_log"].to(at))
    xh = xc.reshape(-1, nh, cfg.mamba_headdim)
    y, ssm_state = ssd_decode_step(xh, dt, A, Bm, Cm, ssm_state)
    y = y + p["D_skip"].to(dt_)[None, :, None] * xh
    y = y.reshape(-1, dI) * F.silu(z)
    out = y @ p["out_proj"].to(dt_)
    return out[:, None], window[:, 1:], ssm_state
