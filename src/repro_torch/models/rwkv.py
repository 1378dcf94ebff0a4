"""RWKV-6 ("Finch"): an attention-free LM with a data-dependent decay per
channel (counterpart of ``repro.models.rwkv``).

WKV6 recurrence per head (state S: hd x hd):
    y_t = r_t · (S_{t-1} + (u ⊙ k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(ww_t)) ∈ (0, 1)

Prefill uses the chunked parallel form (chunk Q = ``cfg.rwkv_chunk``) in a
Python loop over chunks that carries the state: every decay is a
difference of an inclusive cumsum of log w (<= 0) along valid (past to
present) directions, so no ``exp`` argument is positive.  The intra-chunk
decay is (B, Q, H, Q, hd) a chunk; ``repro``'s three-operand product over
it is written as a pair, so that at most two tensors of that size are
alive (at B = 32, Q = 128, d = 2048 one is 4.29 GB in float32).  Decode is
``wkv6_step`` in a loop over layers (``repro`` scans them); the serve state
is O(1) in the sequence length.  Internals run in float32, float64 for a
float64 model (``acc_dtype``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.distributed.sharding import NULL_CTX, ShardingCtx
from repro_torch.models.common import (
    FlatParamsLM,
    ParamSpec,
    Params,
    _pad_seq,
    acc_dtype,
    batch_local,
    embed_rows,
    from_shard,
    head_logits,
    NO_ROWS,
    DecodeRows,
    new_layers_like,
    next_token_ce,
    remat,
    rms_norm,
    shard_roles,
    to_shard,
    torch_dtype,
)
from repro_torch.models.transformer import TensorSpec

TMIX_LORA = 32
DECAY_LORA = 64
# the weights whose rows (their products' contraction) a decode step's
# products may meet with the token's rows gathered instead
# (``DecodeRows.times``)
ROWS_FIRST = ("wr", "wk", "wv", "wg", "tmix_w1", "dec_w1", "cm_wk", "cm_wr")


def _group_norm_heads(y, scale, bias, eps, H):
    """y: (B, S, H, hd): LayerNorm per head (RWKV's ln_x), with the
    population variance (``jnp.var``'s; ``torch.var`` defaults to
    ``correction=1``)."""
    B, S, _, hd = y.shape
    at = acc_dtype(y.dtype)
    yf = y.to(at)
    mu = torch.mean(yf, dim=-1, keepdim=True)
    var = torch.var(yf, dim=-1, keepdim=True, correction=0)
    yn = ((yf - mu) * torch.rsqrt(var + eps)).reshape(B, S, H * hd)
    return (yn * scale.to(at) + bias.to(at)).to(y.dtype)


def wkv6_chunked(
    r: torch.Tensor,     # (B, S, H, hd)
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,  # (B, S, H, hd) <= 0 (log decay per channel)
    u: torch.Tensor,     # (H, hd) bonus
    chunk: int,
    S0: Optional[torch.Tensor] = None,  # (B, H, hd, hd) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, hd) in r's dtype, final state (B, H, hd, hd)
    in float32, or float64 for float64 inputs).  ``r`` a DTensor sharded
    over its rows and heads: each rank scans its own (``shard_roles``)."""
    roles = shard_roles(r, 2) if isinstance(r, DTensor) else None
    if roles is not None:
        mesh, bh, st = r.device_mesh, {"batch": 0, "heads": 2}, \
            {"batch": 0, "heads": 1}
        B, S, H, hd = r.shape
        y, s = wkv6_chunked(
            *(to_shard(t, mesh, roles, bh) for t in (r, k, v, logw)),
            to_shard(u, mesh, roles, {"heads": 0}), chunk,
            None if S0 is None else to_shard(S0, mesh, roles, st))
        return (from_shard(y, mesh, roles, bh, (B, S, H, hd)),
                from_shard(s, mesh, roles, st, (B, H, hd, hd)))
    B, S, H, hd = r.shape
    Q = int(min(chunk, S))
    S_orig = S
    if S % Q:  # ragged tail: logw = 0 (w = 1), r = k = v = 0: a no-op
        pad = Q - S % Q
        r, k, v, logw = (_pad_seq(a, pad) for a in (r, k, v, logw))
        S += pad
    at = acc_dtype(r.dtype)
    rf, kf, vf, lw = (a.to(at) for a in (r, k, v, logw))
    uf = u.to(at)
    Sst = (batch_local(torch.zeros_like,
                       rf[:, 0, :, :, None].expand(B, H, hd, hd))
           if S0 is None else S0)
    # i <= j, the entries the strict past (i > j) leaves at 0: (Q, 1, Q, 1)
    not_past = torch.ones(Q, Q, dtype=torch.bool,
                          device=r.device).triu()[:, None, :, None]
    ys = []
    for c0 in range(0, S, Q):
        r_c, k_c, v_c, lw_c = (a[:, c0:c0 + Q] for a in (rf, kf, vf, lw))
        c = torch.cumsum(lw_c, dim=1)  # inclusive cumsum (B, Q, H, hd)
        # intra-chunk: coeff(i > j) = exp(c_i - lw_i - c_j), the decay over
        # j+1 … i-1, laid out (B, i, H, j, hd); times k, then r contracted
        # over hd as a batched product
        ct = c.transpose(1, 2)[:, None]  # (B, 1, H, Q, hd)
        decay = (c - lw_c)[:, :, :, None, :] - ct
        decay = decay.masked_fill_(not_past, float("-inf")).exp_()
        dk = decay * k_c.transpose(1, 2)[:, None]
        del decay
        A = torch.matmul(dk, r_c[..., None])[..., 0]  # (B, i, H, j)
        del dk
        A = A.permute(0, 2, 1, 3)  # (B, H, i, j)
        diag = (r_c * uf * k_c).sum(-1).transpose(1, 2)  # (B, H, Q)
        A = A + torch.diag_embed(diag)
        y_intra = torch.matmul(A, v_c.transpose(1, 2))  # (B, H, Q, hd)
        # inter-chunk: decay from the chunk's start to i-1 = exp(c_i - lw_i)
        r_in = r_c * torch.exp(c - lw_c)
        y_inter = torch.matmul(r_in.transpose(1, 2), Sst)
        # state: S' = diag(exp(c_Q)) S + Σ_j exp(c_Q - c_j) k_j v_j^T
        k_out = k_c * torch.exp(c[:, -1][:, None] - c)  # (B, Q, H, hd)
        Sst = (torch.exp(c[:, -1])[..., None] * Sst
               + torch.matmul(k_out.permute(0, 2, 3, 1), v_c.transpose(1, 2)))
        ys.append((y_intra + y_inter).transpose(1, 2))
    y = torch.cat(ys, dim=1)[:, :S_orig]
    return y.to(r.dtype), Sst


def wkv6_step(r, k, v, logw, u, Sst):
    """Single token.  r / k / v / logw: (B, H, hd); Sst: (B, H, hd, hd)
    float32.  A state that is a DTensor sharded over its rows (and heads)
    steps on each rank's own, the inputs cut to them (``shard_roles``):
    the state never moves, only the token's inputs."""
    roles = shard_roles(Sst, 1) if isinstance(Sst, DTensor) else None
    if roles is not None and "batch" in roles:
        mesh, bh = Sst.device_mesh, {"batch": 0, "heads": 1}
        y, S_new = wkv6_step(
            *(to_shard(t, mesh, roles, bh) for t in (r, k, v, logw)),
            to_shard(u, mesh, roles, {"heads": 0}),
            to_shard(Sst, mesh, roles, bh))
        return (from_shard(y, mesh, roles, bh, tuple(r.shape)),
                from_shard(S_new, mesh, roles, bh, tuple(Sst.shape)))
    at = acc_dtype(r.dtype)
    rf, kf, vf = r.to(at), k.to(at), v.to(at)
    bonus = Sst + (kf * u.to(at))[..., None] * vf[..., None, :]
    y = torch.einsum("bhd,bhde->bhe", rf, bonus)
    S_new = (torch.exp(logw.to(at))[..., None] * Sst
             + kf[..., None] * vf[..., None, :])
    return y.to(r.dtype), S_new


def _columns_as(w: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``w`` (n, H·hd) with its columns cut as the DTensor ``ref`` (B, S, H,
    hd) cuts its heads over the mesh dimensions where ``w`` is replicated:
    a product with it makes only this rank's heads' channels (a local
    slice, no collective).  ``w`` itself otherwise."""
    if not (isinstance(w, DTensor) and isinstance(ref, DTensor)) or \
            Shard(1) in w.placements:  # its columns already cut (FSDP)
        return w
    pl = [Shard(1) if q.is_replicate() and type(p) is Shard and p.dim == 2
          else q for p, q in zip(ref.placements, w.placements)]
    return w.redistribute(w.device_mesh, pl) if pl != list(w.placements) \
        else w


def _shift(h: torch.Tensor) -> torch.Tensor:
    """The token shift: each position's previous normed input, zeros at
    the first; on a DTensor sharded over its rows and channels, each rank
    shifts its own (torch 2.11's DTensor has no strategy for the pad and
    gathers the whole tensor)."""
    roles = shard_roles(h, 2) if isinstance(h, DTensor) else None
    if roles is not None:
        dims = {"batch": 0, "heads": 2}
        return from_shard(_shift(to_shard(h, h.device_mesh, roles, dims)),
                          h.device_mesh, roles, dims, tuple(h.shape))
    return F.pad(h[:, :-1], (0, 0, 1, 0))


class RWKVLM(FlatParamsLM):
    """Over a flat parameter dict (``FlatParamsLM``); read in float32: the
    four norms, the decay and its LoRA, the bonus ``u`` and ln_x."""

    KEEP = ("ln0", "ln1", "ln2", "final_norm", "decay_base", "dec_w1",
            "dec_w2", "u", "ln_x_scale", "ln_x_bias")

    # ------------------------------------------------------------------ params
    def param_table(self) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        d, ff, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
        H, hd = cfg.num_heads, cfg.head_dim
        assert H * hd == d, "rwkv requires num_heads*head_dim == d_model"
        lead, lx = (L,), ("layers",)
        return {
            "tok_embed": ParamSpec((V, d), ("vocab", "embed"), scale=0.02),
            "ln0": ParamSpec((d,), ("norm",), init="zeros"),
            "final_norm": ParamSpec((d,), ("norm",), init="zeros"),
            "lm_head": ParamSpec((d, V), ("embed", "vocab")),
            # time-mix
            "ln1": ParamSpec(lead + (d,), lx + ("norm",), init="zeros"),
            "mu_x": ParamSpec(lead + (d,), lx + ("norm",), init="zeros"),
            "mu_5": ParamSpec(lead + (5, d), lx + ("stack", "norm"),
                              init="zeros"),
            "tmix_w1": ParamSpec(lead + (d, 5 * TMIX_LORA),
                                 lx + ("embed", None)),
            "tmix_w2": ParamSpec(lead + (5, TMIX_LORA, d),
                                 lx + ("stack", None, "embed"), scale=0.01),
            "wr": ParamSpec(lead + (d, d), lx + ("embed", "ff")),
            "wk": ParamSpec(lead + (d, d), lx + ("embed", "ff")),
            "wv": ParamSpec(lead + (d, d), lx + ("embed", "ff")),
            "wg": ParamSpec(lead + (d, d), lx + ("embed", "ff")),
            "wo": ParamSpec(lead + (d, d), lx + ("ff", "embed")),
            "decay_base": ParamSpec(lead + (d,), lx + ("norm",), init="zeros"),
            "dec_w1": ParamSpec(lead + (d, DECAY_LORA), lx + ("embed", None)),
            "dec_w2": ParamSpec(lead + (DECAY_LORA, d), lx + (None, "embed"),
                                scale=0.01),
            "u": ParamSpec(lead + (H, hd), lx + ("heads", "head_dim"),
                           init="zeros"),
            "ln_x_scale": ParamSpec(lead + (d,), lx + ("norm",), init="ones"),
            "ln_x_bias": ParamSpec(lead + (d,), lx + ("norm",), init="zeros"),
            # channel-mix
            "ln2": ParamSpec(lead + (d,), lx + ("norm",), init="zeros"),
            "cm_mu_k": ParamSpec(lead + (d,), lx + ("norm",), init="zeros"),
            "cm_mu_r": ParamSpec(lead + (d,), lx + ("norm",), init="zeros"),
            "cm_wk": ParamSpec(lead + (d, ff), lx + ("embed", "ff")),
            "cm_wv": ParamSpec(lead + (ff, d), lx + ("ff", "embed")),
            "cm_wr": ParamSpec(lead + (d, d), lx + ("embed", "ff")),
        }

    def _layer_names(self):
        skip = {"tok_embed", "ln0", "final_norm", "lm_head"}
        return [k for k in self.param_table() if k not in skip]

    def _layer(self, params: Params, i: int) -> Params:
        return {n: params[n][i] for n in self._layer_names()}

    def _embed(self, params, tokens):
        """The tokens' rows (vocab-parallel on a vocab-sharded table),
        normed."""
        emb = params["tok_embed"].to(torch_dtype(self.cfg.compute_dtype))
        x = embed_rows(emb, tokens)
        return rms_norm(x, params["ln0"], self.cfg.norm_eps)

    # -------------------------------------------------------------- time mix
    def _tmix_inputs(self, p, x, x_prev, rows=NO_ROWS):
        """Data-dependent token-shift lerp (ddlerp).  x, x_prev: (B, S, d).
        Returns the feeds (xw, xk, xv, xr, xg).  ``rows.times`` makes the
        products of rows and weights (a decode step's ``DecodeRows``)."""
        dt = x.dtype
        delta = x_prev - x
        xx = x + delta * p["mu_x"].to(dt)
        lora = torch.tanh(rows.times(xx, p["tmix_w1"].to(dt))[0])
        lora = lora.reshape(*lora.shape[:2], 5, TMIX_LORA)
        mixes = torch.einsum("bsmk,mkd->bsmd", lora, p["tmix_w2"].to(dt))
        mixes = mixes + p["mu_5"].to(dt)  # (B, S, 5, d)
        feeds = x[:, :, None, :] + delta[:, :, None, :] * mixes
        return tuple(feeds[:, :, i] for i in range(5))

    def wkv_inputs(self, p, h, h_prev, rows=NO_ROWS):
        """The recurrence's inputs from the normed input ``h`` (B, S, d)
        and its shift: (r, k, v, logw) (B, S, H, hd), ``logw`` in float32
        (float64 for a float64 model), and the gate g (B, S, d)."""
        cfg = self.cfg
        H, hd = cfg.num_heads, cfg.head_dim
        dt, at = h.dtype, acc_dtype(h.dtype)
        B, S, _ = h.shape
        xw, xk, xv, xr, xg = self._tmix_inputs(p, h, h_prev, rows)
        r = rows.times(xr, p["wr"].to(dt))[0].reshape(B, S, H, hd)
        k = rows.times(xk, p["wk"].to(dt))[0].reshape(B, S, H, hd)
        v = rows.times(xv, p["wv"].to(dt))[0].reshape(B, S, H, hd)
        g = rows.times(xg, p["wg"].to(dt))[0]
        # the decay LoRA in float32: (xw @ w1) @ w2, the cheap order, its
        # second product on the channels of the heads each rank's r holds
        # (the heads the scan reads there)
        ww = p["decay_base"].to(at) \
            + rows.times(xw.to(at), p["dec_w1"].to(at))[0] \
            @ _columns_as(p["dec_w2"].to(at), r)
        logw = -torch.exp(ww).reshape(B, S, H, hd)  # log w_t <= 0
        return r, k, v, logw, g

    def _tmix_out(self, p, x, y, g):
        """x plus the output side of the time mix on the recurrence's
        output y (B, S, H, hd)."""
        y = _group_norm_heads(y, p["ln_x_scale"], p["ln_x_bias"], 1e-5,
                              self.cfg.num_heads)
        return x + (y * F.silu(g)) @ p["wo"].to(x.dtype)

    def _time_mix_full(self, p, x, ctx, S0=None):
        """Returns (x + time mix, final state, shift state: the last normed
        input, for decode)."""
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        r, k, v, logw, g = self.wkv_inputs(p, h, _shift(h))
        y, S_fin = wkv6_chunked(r, k, v, logw, p["u"], self.cfg.rwkv_chunk,
                                S0)
        # the output projection leaves a sum pending over the heads' shards:
        # settled here (an all-reduce), or the next norm settles it as a
        # reduce-scatter over the sequence that every later op gathers back
        x = ctx.constrain(self._tmix_out(p, x, y, g),
                          ("act_batch", "act_seq", "act_embed"))
        return x, S_fin, h[:, -1]

    # ------------------------------------------------------------ channel mix
    def _channel_mix(self, p, h, h_prev, ctx=NULL_CTX, rows=NO_ROWS):
        dt = h.dtype
        xk = h + (h_prev - h) * p["cm_mu_k"].to(dt)
        xr = h + (h_prev - h) * p["cm_mu_r"].to(dt)
        kk = torch.square(torch.relu(rows.times(xk, p["cm_wk"].to(dt))[0]))
        kk = ctx.constrain(kk, ("act_batch", None, "act_ff"))
        vv = kk @ p["cm_wv"].to(dt)
        rr = torch.sigmoid(rows.times(xr, p["cm_wr"].to(dt))[0])
        return rr * vv

    def _channel_mix_full(self, p, x, ctx):
        """Returns (x + channel mix, shift state)."""
        h = rms_norm(x, p["ln2"], self.cfg.norm_eps)
        x = x + self._channel_mix(p, h, _shift(h), ctx)
        return ctx.constrain(x, ("act_batch", "act_seq", "act_embed")), h[:, -1]

    def _layer_loss(self, p, x, ctx):
        """One layer's time and channel mix, without the states, on the
        weights' FSDP shards gathered."""
        p = ctx.gather_fsdp(p, x.dtype, self.KEEP)
        x = self._time_mix_full(p, x, ctx)[0]
        return self._channel_mix_full(p, x, ctx)[0]

    # ------------------------------------------------------------------ modes
    def _forward_full(self, params, tokens, ctx, want_state: bool):
        x = ctx.constrain(self._embed(params, tokens),
                          ("act_batch", "act_seq", "act_embed"))
        states = []
        for i in range(self.cfg.num_layers):
            p_l = self._layer(params, i)
            if not want_state:  # the loss path: remat, as ``repro``
                x = remat(self.cfg, self._layer_loss, p_l, x, ctx)
                continue
            x, S_fin, sh_t = self._time_mix_full(p_l, x, ctx)
            x, sh_c = self._channel_mix_full(p_l, x, ctx)
            states.append((S_fin, sh_t, sh_c))
        if not want_state:
            return x, None
        return x, tuple(torch.stack(s) for s in zip(*states))

    def loss(self, params, batch, ctx: ShardingCtx = NULL_CTX):
        """Mean next-token cross entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (label -1 is ignored); returns (loss, {"ce",
        "aux"}), aux zero."""
        cfg = self.cfg
        x, _ = self._forward_full(params, batch["tokens"], ctx, False)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        head = ctx.gather_fsdp(params["lm_head"].to(x.dtype))
        logits = ctx.constrain(x @ head,
                               ("act_batch", "act_seq", "act_vocab"))
        labels = torch.as_tensor(batch["labels"], device=x.device)
        ce = next_token_ce(logits, labels)
        return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}

    forward = loss

    def prefill(self, params, batch, ctx: ShardingCtx = NULL_CTX,
                capacity: Optional[int] = None):
        """Returns (last-position logits (B, V), state).  ``capacity`` is
        ignored: the state is O(1) in the sequence length."""
        cfg = self.cfg
        x, (S_fin, sh_t, sh_c) = self._forward_full(params, batch["tokens"],
                                                    ctx, True)
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = head_logits(x, params["lm_head"].to(x.dtype), ctx)[:, 0]
        return logits, {"wkv": S_fin, "shift_t": sh_t, "shift_c": sh_c}

    def cache_specs(self, batch: int, seq_len: int) -> Dict[str, TensorSpec]:
        """The "cache" is a constant-size state: the WKV state in float32
        (float64 for a float64 model), the shifts in the compute dtype."""
        cfg = self.cfg
        H, hd, d, L = cfg.num_heads, cfg.head_dim, cfg.d_model, cfg.num_layers
        dt = torch_dtype(cfg.compute_dtype)
        return {
            "wkv": TensorSpec((L, batch, H, hd, hd), acc_dtype(dt)),
            "shift_t": TensorSpec((L, batch, d), dt),
            "shift_c": TensorSpec((L, batch, d), dt),
        }

    def decode(self, params, tokens, cache, t, ctx: ShardingCtx = NULL_CTX):
        """tokens: (B, 1); ``t`` unused (the state carries the position).
        Returns (logits, state)."""
        cfg = self.cfg
        x = self._embed(params, tokens)  # (B, 1, d)
        wkv, sh_t, sh_c = (new_layers_like(cache[n])
                           for n in ("wkv", "shift_t", "shift_c"))
        rows = DecodeRows(ctx, x)
        x = rows.hold(x)
        for i in range(cfg.num_layers):
            p_l = rows.weights(self._layer(params, i), x.dtype, self.KEEP,
                               ROWS_FIRST)
            h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
            r, k, v, logw, g = self.wkv_inputs(
                p_l, rows.spread(h), rows.spread(cache["shift_t"][i][:, None]),
                rows)
            y, S_new = wkv6_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0],
                                 p_l["u"], cache["wkv"][i])
            x = rows.hold(self._tmix_out(p_l, x, y[:, None], g))
            h2 = rms_norm(x, p_l["ln2"], cfg.norm_eps)
            x = rows.hold(x + self._channel_mix(
                p_l, rows.spread(h2),
                rows.spread(cache["shift_c"][i][:, None]), ctx, rows))
            wkv[i], sh_t[i], sh_c[i] = S_new, h[:, 0], h2[:, 0]
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = head_logits(x, params["lm_head"].to(x.dtype), ctx)[:, 0]
        return logits, {"wkv": wkv, "shift_t": sh_t, "shift_c": sh_c}
