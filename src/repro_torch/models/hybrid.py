"""zamba2-style hybrid LM: a Mamba2 backbone and one SHARED transformer
block applied after every ``attn_every`` Mamba blocks, each application
with its own KV cache at serve time (counterpart of
``repro.models.hybrid``).

Parameters are ``repro``'s names and layouts (the Mamba blocks'
layer-stacked under ``m/``), so ``convert.lm_params_from_numpy`` carries
a ``repro`` parameter dict across.  The shared block runs on the port's
``apply_rope``, ``blockwise_attention``, ``cache_update``,
``decode_attention`` and ``glu_mlp``.  The cache holds the applications'
K / V (sharing one ``pos``), each layer's SSM state in float32 and its
conv state (the layer's last k − 1 conv inputs) in the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import NULL_CTX, ShardingCtx
from repro_torch.models.common import (
    FlatParamsLM,
    ParamSpec,
    Params,
    acc_dtype,
    apply_rope,
    blockwise_attention,
    cache_update,
    decode_attention,
    embed_rows,
    positions_like,
    glu_mlp,
    head_logits,
    DecodeRows,
    new_layers_like,
    next_token_ce,
    remat,
    rms_norm,
    torch_dtype,
)
from repro_torch.models.ssm import (
    MAMBA_KEEP,
    MAMBA_ROWS_FIRST,
    mamba_block_decode,
    mamba_block_full,
    mamba_param_table,
)
from repro_torch.models.transformer import TensorSpec


def _mamba_residual(p_l, x, cfg, ctx):
    """The loss path's Mamba block, on the weights' FSDP shards gathered."""
    p_l = ctx.gather_fsdp(p_l, x.dtype, MAMBA_KEEP)
    return _settled(x + mamba_block_full(p_l, x, cfg, ctx)[0], ctx)


def _heads_as(wq, w):
    """A K / V projection ``w`` (d, H, hd) sharded on its heads as ``wq``
    is (a local slice where ``w`` is replicated; its other shards kept):
    with ``kv_heads`` unsharded, every "model" rank would project K and V
    for every head, and attention only reads its own (K and V have the
    queries' head count here)."""
    if not isinstance(wq, DTensor) or not isinstance(w, DTensor):
        return w
    return w.redistribute(w.device_mesh, [
        qp if isinstance(qp, Shard) and qp.dim == 1 else wp
        for qp, wp in zip(wq.placements, w.placements)])


def _settled(x, ctx):
    """``x`` (B, S, d) laid out as the residual stream is: an output
    projection leaves a sum pending over its shards, which the next norm
    would otherwise settle as a reduce-scatter over the sequence that every
    later op gathers back."""
    return ctx.constrain(x, ("act_batch", "act_seq", "act_embed"))


class HybridLM(FlatParamsLM):
    """Over a flat parameter dict (``FlatParamsLM``); read in float32: the
    norms and the Mamba step bias and decay rate."""

    KEEP = ("final_norm", "s_attn_norm", "s_mlp_norm") + tuple(
        f"m/{n}" for n in MAMBA_KEEP)

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.n_shared_apps = cfg.num_layers // cfg.attn_every

    # ------------------------------------------------------------------ params
    def param_table(self) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        d, H, Hkv, hd, ff, V = (
            cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size,
        )
        t: Dict[str, ParamSpec] = {
            "tok_embed": ParamSpec((V, d), ("vocab", "embed"), scale=0.02),
            "final_norm": ParamSpec((d,), ("norm",), init="zeros"),
            "lm_head": ParamSpec((d, V), ("embed", "vocab")),
            # shared transformer block (single copy)
            "s_attn_norm": ParamSpec((d,), ("norm",), init="zeros"),
            "s_wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim")),
            "s_wk": ParamSpec((d, Hkv, hd), ("embed", "kv_heads", "head_dim")),
            "s_wv": ParamSpec((d, Hkv, hd), ("embed", "kv_heads", "head_dim")),
            "s_wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed")),
            "s_mlp_norm": ParamSpec((d,), ("norm",), init="zeros"),
            "s_w_gate": ParamSpec((d, ff), ("embed", "ff")),
            "s_w_up": ParamSpec((d, ff), ("embed", "ff")),
            "s_w_down": ParamSpec((ff, d), ("ff", "embed")),
        }
        mt = mamba_param_table(cfg, (cfg.num_layers,), ("layers",))
        t.update({f"m/{k}": v for k, v in mt.items()})
        return t

    def _mamba_names(self):
        return [k[2:] for k in self.param_table() if k.startswith("m/")]

    def _layer(self, params: Params, i: int) -> Params:
        return {n: params[f"m/{n}"][i] for n in self._mamba_names()}

    def _shared_gathered(self, params, ctx):
        """``params`` with the shared block's weights' FSDP shards gathered
        (the loss path's)."""
        return {**params, **ctx.gather_fsdp(
            {k: v for k, v in params.items() if k.startswith("s_")},
            torch_dtype(self.cfg.compute_dtype), self.KEEP)}

    def _embed(self, params, tokens):
        """The tokens' rows (vocab-parallel on a vocab-sharded table)."""
        emb = params["tok_embed"].to(torch_dtype(self.cfg.compute_dtype))
        return embed_rows(emb, tokens)

    # ------------------------------------------------------------ shared block
    def _shared_qkv(self, params, h, pos):
        cfg = self.cfg
        dt = h.dtype
        B, S, d = h.shape

        def proj(w):
            return (h @ w.to(dt).reshape(d, -1)).reshape(B, S, *w.shape[1:])

        wq = params["s_wq"]
        q = apply_rope(proj(wq), pos, cfg.rope_theta)
        k = apply_rope(proj(_heads_as(wq, params["s_wk"])), pos,
                       cfg.rope_theta)
        return q, k, proj(_heads_as(wq, params["s_wv"]))

    def _shared_out(self, params, x, a, ctx):
        """The attention output ``a`` (B, S, H, hd) projected and added to
        ``x``, then the shared SwiGLU MLP."""
        cfg = self.cfg
        B, S, d = x.shape
        wo = params["s_wo"].to(x.dtype)
        x = _settled(x + a.reshape(B, S, -1) @ wo.reshape(-1, d), ctx)
        h2 = rms_norm(x, params["s_mlp_norm"], cfg.norm_eps)
        return x + glu_mlp(h2, params["s_w_gate"], params["s_w_up"],
                           params["s_w_down"], "swiglu", ctx)

    def _shared_full(self, params, x, pos, ctx):
        cfg = self.cfg
        h = rms_norm(x, params["s_attn_norm"], cfg.norm_eps)
        q, k, v = self._shared_qkv(params, h, pos)
        q = ctx.constrain(q, ("act_batch", None, "act_heads", None))
        a = blockwise_attention(q, k, v, pos, pos, causal=True,
                                chunk=cfg.attn_chunk)
        x = self._shared_out(params, x, a, ctx)
        return ctx.constrain(x, ("act_batch", "act_seq", "act_embed")), (k, v)

    def _shared_decode(self, params, x, ck, cv, cp, t, ctx):
        pos_q = t[:, None]
        h = rms_norm(x, params["s_attn_norm"], self.cfg.norm_eps)
        q, k, v = self._shared_qkv(params, h, pos_q)
        ck, cv, cp = cache_update(ck, cv, cp, k, v, t)
        a = decode_attention(q, ck, cv, pos_q, cp)
        return self._shared_out(params, x, a, ctx), ck, cv, cp

    # ------------------------------------------------------------------ modes
    def _forward_full(self, params, tokens, ctx, want_caches: bool):
        cfg = self.cfg
        x = ctx.constrain(self._embed(params, tokens),
                          ("act_batch", "act_seq", "act_embed"))
        pos = positions_like(x)
        kvs, ssm_states, conv_states = [], [], []
        k_conv = cfg.conv_kernel
        for i in range(cfg.num_layers):
            p_l = self._layer(params, i)
            shared = (i + 1) % cfg.attn_every == 0
            if not want_caches:  # the loss path: remat each block, as repro
                x = remat(cfg, _mamba_residual, p_l, x, cfg, ctx)
                if shared:
                    x = remat(cfg, lambda x: self._shared_full(
                        self._shared_gathered(params, ctx), x, pos, ctx)[0],
                        x)
                continue
            # conv state = the trailing k-1 conv INPUTS of this layer
            tail = x[:, -(k_conv - 1):]
            h_t = rms_norm(tail, p_l["m_norm"], cfg.norm_eps)
            conv_states.append(h_t @ p_l["wx"].to(tail.dtype))
            out, h_fin = mamba_block_full(p_l, x, cfg, ctx)
            x = _settled(x + out, ctx)
            ssm_states.append(h_fin)
            if shared:
                x, kv = self._shared_full(params, x, pos, ctx)
                kvs.append(kv)
        caches = None
        if want_caches:
            caches = (torch.stack([k for k, _ in kvs]),
                      torch.stack([v for _, v in kvs]),
                      torch.stack(ssm_states), torch.stack(conv_states))
        return x, pos, caches

    def loss(self, params, batch, ctx: ShardingCtx = NULL_CTX):
        """Mean next-token cross entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (label -1 is ignored); returns (loss, {"ce",
        "aux"}), aux zero."""
        cfg = self.cfg
        x, _, _ = self._forward_full(params, batch["tokens"], ctx, False)
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
        """capacity: total positions the KV caches must hold (prompt +
        planned new tokens); defaults to the prompt length.  Returns
        (last-position logits (B, V), cache)."""
        cfg = self.cfg
        x, pos, (ks, vs, ssm, conv) = self._forward_full(
            params, batch["tokens"], ctx, True)
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = head_logits(x, params["lm_head"].to(x.dtype), ctx)[:, 0]
        S = pos.shape[1]
        C = max(capacity or S, S)
        if C > S:  # decode headroom: empty slots marked pos = -1
            pad = (0, 0, 0, 0, 0, C - S)
            ks, vs = F.pad(ks, pad), F.pad(vs, pad)
            pos = F.pad(pos, (0, C - S), value=-1)
        return logits, {
            "k": ks, "v": vs, "pos": pos.to(torch.int32), "ssm": ssm,
            "conv": conv.to(torch_dtype(cfg.compute_dtype)),
        }

    def cache_specs(self, batch: int, seq_len: int) -> Dict[str, TensorSpec]:
        """The state is float32 (float64 for a float64 model), the conv
        state and K / V in the compute dtype."""
        cfg = self.cfg
        dt = torch_dtype(cfg.compute_dtype)
        dI = cfg.mamba_expand * cfg.d_model
        nh = dI // cfg.mamba_headdim
        kv = TensorSpec((self.n_shared_apps, batch, seq_len, cfg.num_kv_heads,
                         cfg.head_dim), dt)
        return {
            "k": kv, "v": kv,
            "pos": TensorSpec((batch, seq_len), torch.int32),
            "ssm": TensorSpec((cfg.num_layers, batch, nh, cfg.mamba_headdim,
                               cfg.ssm_state), acc_dtype(dt)),
            "conv": TensorSpec((cfg.num_layers, batch, cfg.conv_kernel - 1,
                                dI), dt),
        }

    def decode(self, params, tokens, cache, t, ctx: ShardingCtx = NULL_CTX):
        """tokens: (B, 1); t: (B,) current position.  Returns (logits,
        cache)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        cp = cache["pos"]
        new_ssm, new_conv, new_k, new_v = (
            new_layers_like(cache[n]) for n in ("ssm", "conv", "k", "v"))
        app = 0
        rows = DecodeRows(ctx, x)
        shared = {**params, **rows.weights(
            {k: v for k, v in params.items() if k.startswith("s_")},
            x.dtype, self.KEEP)}
        x = rows.hold(x)
        for i in range(cfg.num_layers):
            p_l = rows.weights(self._layer(params, i), x.dtype, MAMBA_KEEP,
                               MAMBA_ROWS_FIRST)
            out, new_conv[i], new_ssm[i] = mamba_block_decode(
                p_l, x, cfg, cache["conv"][i], cache["ssm"][i], ctx, rows)
            x = rows.hold(x + out)
            if (i + 1) % cfg.attn_every == 0:
                x, new_k[app], new_v[app], cp = self._shared_decode(
                    shared, x, cache["k"][app], cache["v"][app], cp, t, ctx)
                x = rows.hold(x)
                app += 1
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = head_logits(x, params["lm_head"].to(x.dtype), ctx)[:, 0]
        return logits, {"k": new_k, "v": new_v, "pos": cp, "ssm": new_ssm,
                        "conv": new_conv}
