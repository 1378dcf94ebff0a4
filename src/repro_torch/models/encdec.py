"""Encoder-decoder transformer: the seamless-m4t backbone (counterpart of
``repro.models.encdec``).

The speech frontend is a stub, as in ``repro``: the inputs are
precomputed frame embeddings ``frames: (B, S, d_model)``.  The encoder is
bidirectional with RoPE on q and k; the decoder is causal, with a
cross-attention to the encoder output (no RoPE) after each self-attention.
Serving splits as ``repro``'s does: ``prefill`` encodes the frames, runs
the decoder over the prompt and keeps each layer's cross-attention K / V;
``decode`` steps the decoder with a ring-buffer self-attention cache and
attends over that static encoder cache.

Parameters are ``repro``'s names and layouts (``param_table``), so
``convert.lm_params_from_numpy`` carries a ``repro`` parameter dict
across.  The layers are Python loops where ``repro`` scans; with
``cfg.remat`` each layer body of ``loss`` is recomputed in the backward
pass (``common.remat``), as ``repro`` wraps it in ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import NULL_CTX, ShardingCtx
from repro_torch.models.common import (
    FlatParamsLM,
    ParamSpec,
    Params,
    apply_rope,
    blockwise_attention,
    cache_update,
    decode_attention,
    embed_rows,
    glu_mlp,
    next_token_ce,
    remat,
    rms_norm,
    torch_dtype,
)
from repro_torch.models.transformer import TensorSpec

INT32_MAX = 2 ** 31 - 1


class EncDecLM(FlatParamsLM):
    """Over a flat parameter dict (``FlatParamsLM``); ``rms_norm`` reads
    the norm weights in float32."""

    KEEP = ("enc_final_norm", "final_norm", "enc/attn_norm", "enc/mlp_norm",
            "dec/attn_norm", "dec/xattn_norm", "dec/mlp_norm")

    def param_table(self) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        d, H, Hkv, hd, ff, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim, cfg.d_ff, cfg.vocab_size)
        t: Dict[str, ParamSpec] = {
            "tok_embed": ParamSpec((V, d), ("vocab", "embed"), scale=0.02),
            "enc_final_norm": ParamSpec((d,), ("norm",), init="zeros"),
            "final_norm": ParamSpec((d,), ("norm",), init="zeros"),
            "lm_head": ParamSpec((d, V), ("embed", "vocab")),
        }

        def attn_block(prefix, lead):
            ax = ("layers",)
            kv = ax + ("embed", "kv_heads", "head_dim")
            return {
                f"{prefix}attn_norm": ParamSpec(lead + (d,), ax + ("norm",),
                                                init="zeros"),
                f"{prefix}wq": ParamSpec(lead + (d, H, hd),
                                         ax + ("embed", "heads", "head_dim")),
                f"{prefix}wk": ParamSpec(lead + (d, Hkv, hd), kv),
                f"{prefix}wv": ParamSpec(lead + (d, Hkv, hd), kv),
                f"{prefix}wo": ParamSpec(lead + (H, hd, d),
                                         ax + ("heads", "head_dim", "embed")),
            }

        def mlp_block(prefix, lead):
            ax = ("layers",)
            up, down = ax + ("embed", "ff"), ax + ("ff", "embed")
            return {
                f"{prefix}mlp_norm": ParamSpec(lead + (d,), ax + ("norm",),
                                               init="zeros"),
                f"{prefix}w_gate": ParamSpec(lead + (d, ff), up),
                f"{prefix}w_up": ParamSpec(lead + (d, ff), up),
                f"{prefix}w_down": ParamSpec(lead + (ff, d), down),
            }

        le, ld = (cfg.encoder_layers,), (cfg.num_layers,)
        t.update(attn_block("enc/", le))
        t.update(mlp_block("enc/", le))
        t.update(attn_block("dec/", ld))
        t.update(attn_block("dec/x", ld))  # cross-attention
        t.update(mlp_block("dec/", ld))
        return t

    def _layer_keep(self):
        """``KEEP``'s names as ``_stack`` gives a layer's weights."""
        return [k.split("/")[-1] for k in self.KEEP]

    def _stack(self, params: Params, side: str, i: int) -> Params:
        """Layer ``i`` of the ``side/`` ("enc" or "dec") weights, by their
        names without the prefix."""
        n = len(side) + 1
        return {k[n:]: p[i] for k, p in params.items()
                if k.startswith(side + "/")}

    # ------------------------------------------------------------------ layers
    def _proj(self, h, w):
        B, S, d = h.shape
        return (h @ w.to(h.dtype).reshape(d, -1)).reshape(B, S, *w.shape[1:])

    def _out(self, p, prefix, a, dt):
        B, S = a.shape[:2]
        wo = p[f"{prefix}wo"].to(dt)
        return a.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])

    def _attn(self, p, prefix, xq, pos_q, pos_k, causal, ctx, kv_src=None,
              rope=True):
        """Pre-norm attention; ``kv_src=None`` is self-attention on the
        normed ``xq``.  Returns (output projected to d, (k, v))."""
        cfg = self.cfg
        h = rms_norm(xq, p[f"{prefix}attn_norm"], cfg.norm_eps)
        src = h if kv_src is None else kv_src
        q = self._proj(h, p[f"{prefix}wq"])
        k = self._proj(src, p[f"{prefix}wk"])
        v = self._proj(src, p[f"{prefix}wv"])
        if rope:
            q = apply_rope(q, pos_q, cfg.rope_theta)
            k = apply_rope(k, pos_k, cfg.rope_theta)
        q = ctx.constrain(q, ("act_batch", None, "act_heads", None))
        out = blockwise_attention(q, k, v, pos_q, pos_k, causal=causal,
                                  chunk=cfg.attn_chunk)
        return self._out(p, prefix, out, xq.dtype), (k, v)

    def _mlp(self, p, x, ctx):
        h = rms_norm(x, p["mlp_norm"], self.cfg.norm_eps)
        return glu_mlp(h, p["w_gate"], p["w_up"], p["w_down"],
                       self.cfg.mlp_act, ctx)

    @staticmethod
    def _positions(B: int, S: int, device) -> torch.Tensor:
        return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)

    def _encode(self, params, frames, ctx, loss: bool = False):
        """Returns (the normed encoder output, its positions)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.compute_dtype)
        x = torch.as_tensor(frames, device=params["tok_embed"].device).to(dt)
        x = ctx.constrain(x, ("act_batch", "act_seq", "act_embed"))
        B, S, _ = x.shape
        pos = self._positions(B, S, x.device)

        def body(x, p_l):
            if loss:  # the loss path: the weights' FSDP shards gathered
                p_l = ctx.gather_fsdp(p_l, dt, self._layer_keep())
            a, _ = self._attn(p_l, "", x, pos, pos, causal=False, ctx=ctx)
            x = x + a
            x = x + self._mlp(p_l, x, ctx)
            return ctx.constrain(x, ("act_batch", "act_seq", "act_embed"))

        for i in range(cfg.encoder_layers):
            x = remat(cfg, body, x, self._stack(params, "enc", i))
        return rms_norm(x, params["enc_final_norm"], cfg.norm_eps), pos

    def _embed(self, params, tokens, loss: bool = False):
        """The tokens' rows (vocab-parallel on the loss path)."""
        emb = params["tok_embed"].to(torch_dtype(self.cfg.compute_dtype))
        return embed_rows(emb, tokens, vocab_parallel=loss)

    def _dec_layer(self, p_l, x, pos, enc_out, enc_pos, ctx):
        """One decoder layer over the full sequence.  Returns (x, self K / V,
        cross K / V)."""
        a, kv_self = self._attn(p_l, "", x, pos, pos, causal=True, ctx=ctx)
        x = x + a
        a, kv_cross = self._attn(p_l, "x", x, pos, enc_pos, causal=False,
                                 ctx=ctx, kv_src=enc_out, rope=False)
        x = x + a
        x = x + self._mlp(p_l, x, ctx)
        x = ctx.constrain(x, ("act_batch", "act_seq", "act_embed"))
        return x, kv_self, kv_cross

    def _decoder_full(self, params, tokens, enc_out, enc_pos, ctx,
                      collect_caches: bool):
        """Returns (the normed decoder output, positions, ((k, v), (xk, xv))
        stacked over the layers, or None)."""
        cfg = self.cfg
        x = ctx.constrain(self._embed(params, tokens,
                                      loss=not collect_caches),
                          ("act_batch", "act_seq", "act_embed"))
        B, S, _ = x.shape
        pos = self._positions(B, S, x.device)
        ks, vs, xks, xvs = [], [], [], []
        for i in range(cfg.num_layers):
            p_l = self._stack(params, "dec", i)
            if not collect_caches:
                x = remat(cfg, lambda x, p: self._dec_layer(
                    ctx.gather_fsdp(p, x.dtype, self._layer_keep()), x, pos,
                    enc_out, enc_pos, ctx)[0], x, p_l)
                continue
            x, (k, v), (xk, xv) = self._dec_layer(p_l, x, pos, enc_out,
                                                  enc_pos, ctx)
            ks.append(k)
            vs.append(v)
            xks.append(xk)
            xvs.append(xv)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if not collect_caches:
            return x, pos, None
        stack = torch.stack
        return x, pos, ((stack(ks), stack(vs)), (stack(xks), stack(xvs)))

    def _logits(self, params, x, ctx: ShardingCtx = NULL_CTX):
        """The LM head's logits, its FSDP shards gathered first under
        ``ctx`` (the loss path's)."""
        return x @ ctx.gather_fsdp(params["lm_head"].to(x.dtype))

    # --------------------------------------------------------------------- API
    def loss(self, params, batch, ctx: ShardingCtx = NULL_CTX):
        """Mean next-token cross entropy of the decoder over
        ``batch["tokens"]`` given ``batch["frames"]``, against
        ``batch["labels"]`` (label -1 is ignored); returns (loss, {"ce",
        "aux"}), aux zero."""
        enc_out, enc_pos = self._encode(params, batch["frames"], ctx,
                                        loss=True)
        x, _, _ = self._decoder_full(params, batch["tokens"], enc_out,
                                     enc_pos, ctx, collect_caches=False)
        labels = torch.as_tensor(batch["labels"], device=x.device)
        logits = ctx.constrain(self._logits(params, x, ctx),
                               ("act_batch", "act_seq", "act_vocab"))
        ce = next_token_ce(logits, labels)
        return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}

    forward = loss

    def prefill(self, params, batch, ctx: ShardingCtx = NULL_CTX,
                capacity: Optional[int] = None):
        """Encodes ``batch["frames"]`` and runs the decoder over the prompt
        ``batch["tokens"]``.  capacity: positions the self-attention cache
        must hold (prompt + planned new tokens), default the prompt length.
        Returns (last-position logits (B, V), cache: k, v, pos, xk, xv,
        enc_pos)."""
        enc_out, enc_pos = self._encode(params, batch["frames"], ctx)
        x, pos, ((ks, vs), (xks, xvs)) = self._decoder_full(
            params, batch["tokens"], enc_out, enc_pos, ctx,
            collect_caches=True)
        logits = self._logits(params, x[:, -1:])[:, 0]
        S = pos.shape[1]
        C = max(capacity or S, S)
        if C > S:  # decode headroom on the self-attention cache
            pad = (0, 0, 0, 0, 0, C - S)
            ks, vs = F.pad(ks, pad), F.pad(vs, pad)
            pos = F.pad(pos, (0, C - S), value=-1)
        return logits, {"k": ks, "v": vs, "pos": pos.to(torch.int32),
                        "xk": xks, "xv": xvs, "enc_pos": enc_pos}

    def cache_specs(self, batch: int, seq_len: int) -> Dict[str, TensorSpec]:
        """``repro``'s specs as they are: the cross-attention cache and
        ``enc_pos`` take the self-attention cache's ``seq_len``."""
        cfg = self.cfg
        kv = TensorSpec((cfg.num_layers, batch, seq_len, cfg.num_kv_heads,
                         cfg.head_dim), torch_dtype(cfg.compute_dtype))
        pos = TensorSpec((batch, seq_len), torch.int32)
        return {"k": kv, "v": kv, "pos": pos, "xk": kv, "xv": kv,
                "enc_pos": pos}

    def decode(self, params, tokens, cache, t, ctx: ShardingCtx = NULL_CTX):
        """tokens: (B, 1); t: (B,) current position.  Returns (logits,
        cache)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        dt = x.dtype
        cp = cache["pos"]
        pos_q = t[:, None]
        # cross-attention is not causal: a query position past every
        # encoder slot (int32 max) leaves all of them unmasked
        big = torch.full_like(pos_q, INT32_MAX)
        ks, vs = [], []
        for i in range(cfg.num_layers):
            p_l = self._stack(params, "dec", i)
            h = rms_norm(x, p_l["attn_norm"], cfg.norm_eps)
            q = apply_rope(self._proj(h, p_l["wq"]), pos_q, cfg.rope_theta)
            k = apply_rope(self._proj(h, p_l["wk"]), pos_q, cfg.rope_theta)
            ck, cv, cp = cache_update(cache["k"][i], cache["v"][i], cp, k,
                                      self._proj(h, p_l["wv"]), t)
            x = x + self._out(p_l, "", decode_attention(q, ck, cv, pos_q, cp),
                              dt)
            h = rms_norm(x, p_l["xattn_norm"], cfg.norm_eps)
            a = decode_attention(self._proj(h, p_l["xwq"]), cache["xk"][i],
                                 cache["xv"][i], big, cache["enc_pos"])
            x = x + self._out(p_l, "x", a, dt)
            x = x + self._mlp(p_l, x, ctx)
            ks.append(ck)
            vs.append(cv)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x)[:, 0]
        return logits, dict(cache, k=torch.stack(ks), v=torch.stack(vs),
                            pos=cp)
