"""Decoder-only transformer LM: the dense, MoE and VLM-prefix families
(counterpart of ``repro.models.transformer``).

Parameters are ``repro``'s: the same flat names and layer-stacked
``(L, …)`` layouts (``param_table``), so a ``repro`` parameter dict carries
across as it is (``repro_torch.convert.lm_params_from_numpy``).  The
methods take the parameters, as ``repro``'s do, and loop over the layers
where ``repro`` scans.  Serving uses a uniform ring-buffer KV cache:
``decode`` writes the new token's KV at ``slot = t % cache_len`` and attends
over every valid slot, which covers full attention (cache_len == seq_len)
and SWA rolling buffers (cache_len == window) with the same code.

Each weight is used in the compute dtype (``repro`` casts it at every use);
``compute_params`` (``FlatParamsLM``) makes that cast once, and the norm
weights stay float32, which is the dtype ``rms_norm`` reads them in.
``init_compute`` draws the weights straight into that form, one tensor at
a time, for a model whose float32 parameters do not fit beside their
copy.

The MoE family's MLP is ``repro_torch.models.moe.moe_ffn``, whose router
aux term ``loss`` adds in; the VLM family takes precomputed patch
embeddings (``batch["patches"]``), normed and projected in front of the
tokens.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import Partial

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import NULL_CTX, ShardingCtx
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (
    FlatParamsLM,
    LocalKV,
    ParamSpec,
    Params,
    TensorSpec,
    apply_rope,
    blockwise_attention,
    cache_update,
    column_split,
    cut_columns,
    decode_attention,
    embed_rows,
    fold_rows,
    new_layers_like,
    own_part,
    positions_like,
    glu_mlp,
    head_logits,
    next_token_ce,
    remat,
    rms_norm,
    row_split,
    scalar_in,
    split_dims,
    to_shard,
    torch_dtype,
)

NORMS = ("final_norm", "attn_norm", "mlp_norm", "patch_norm")
FAMILIES = ("dense", "moe", "vlm")


class DecoderLM(FlatParamsLM):
    """The decoder of the dense, MoE and VLM families; ``rms_norm`` reads
    the norm weights in float32."""

    KEEP = NORMS

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"DecoderLM: {cfg.name} is family {cfg.family!r}, not one of "
                f"{FAMILIES} (ROADMAP A6 ports the other families)")
        super().__init__(cfg)

    # ------------------------------------------------------------------ params
    def param_table(self) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        L, d, H, Hkv, hd, ff, V = (
            cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size,
        )
        t: Dict[str, ParamSpec] = {
            "tok_embed": ParamSpec((V, d), ("vocab", "embed"), scale=0.02),
            "final_norm": ParamSpec((d,), ("norm",), init="zeros"),
        }
        if not cfg.tie_embeddings:
            t["lm_head"] = ParamSpec((d, V), ("embed", "vocab"))
        lead, lax_ = (L,), ("layers",)
        t.update({
            "attn_norm": ParamSpec(lead + (d,), lax_ + ("norm",), init="zeros"),
            "wq": ParamSpec(lead + (d, H, hd),
                            lax_ + ("embed", "heads", "head_dim")),
            "wk": ParamSpec(lead + (d, Hkv, hd),
                            lax_ + ("embed", "kv_heads", "head_dim")),
            "wv": ParamSpec(lead + (d, Hkv, hd),
                            lax_ + ("embed", "kv_heads", "head_dim")),
            "wo": ParamSpec(lead + (H, hd, d),
                            lax_ + ("heads", "head_dim", "embed")),
            "mlp_norm": ParamSpec(lead + (d,), lax_ + ("norm",), init="zeros"),
        })
        if cfg.qkv_bias:
            t["bq"] = ParamSpec(lead + (H, hd), lax_ + ("heads", "head_dim"),
                                init="zeros")
            t["bk"] = ParamSpec(lead + (Hkv, hd),
                                lax_ + ("kv_heads", "head_dim"), init="zeros")
            t["bv"] = ParamSpec(lead + (Hkv, hd),
                                lax_ + ("kv_heads", "head_dim"), init="zeros")
        if cfg.moe is not None:
            t.update(moe_lib.moe_param_table(cfg, "", L))
        else:
            t["w_gate"] = ParamSpec(lead + (d, ff), lax_ + ("embed", "ff"))
            t["w_up"] = ParamSpec(lead + (d, ff), lax_ + ("embed", "ff"))
            t["w_down"] = ParamSpec(lead + (ff, d), lax_ + ("ff", "embed"))
        if cfg.family == "vlm":
            t["patch_proj"] = ParamSpec((cfg.patch_dim, d), ("patch", "embed"))
            t["patch_norm"] = ParamSpec((cfg.patch_dim,), ("norm",),
                                        init="zeros")
        return t

    # ----------------------------------------------------------------- pieces
    def _layer_names(self):
        cfg = self.cfg
        names = ["attn_norm", "wq", "wk", "wv", "wo", "mlp_norm"]
        if cfg.qkv_bias:
            names += ["bq", "bk", "bv"]
        if cfg.moe is not None:
            names += ["router", "we_gate", "we_up", "we_down"]
            if cfg.moe.shared_experts:
                names += ["ws_gate", "ws_up", "ws_down", "shared_gate"]
        else:
            names += ["w_gate", "w_up", "w_down"]
        return names

    def _layer(self, params: Params, i: int) -> Params:
        return {n: params[n][i] for n in self._layer_names()}

    def _attn_proj_qkv(self, p, h, pos, ctx, local_kv=False,
                       decode=False):
        """(q, k, v).  With ``local_kv`` (the loss path, which needs K / V
        only in attention), KV heads that every "model" rank holds whole
        come as a ``LocalKV``: each rank makes only the KV heads its own
        query heads read (GSPMD splits that work too); in a ``decode``
        step each rank makes its block of their columns (``cut_columns``)."""
        cfg = self.cfg
        dt = h.dtype
        B, S, d = h.shape

        def proj(w):
            w2 = w.to(dt).reshape(d, -1)
            out = cut_columns(h, w2, ctx) if decode else h @ w2
            return out.reshape(B, S, *w.shape[1:])

        # heads the "model" axis does not divide: each rank its own block
        split = split_dims(ctx, "act_heads", h, p["wq"])
        q = column_split(h, p["wq"].to(dt), split, p["bq"].to(dt)
                         if cfg.qkv_bias else None) if split else None
        if q is None:
            q = proj(p["wq"])
            if cfg.qkv_bias:
                q = q + p["bq"].to(dt)
        q = apply_rope(q, pos, cfg.rope_theta)
        q = ctx.constrain(q, ("act_batch", None, "act_heads", None))
        kv_dims = split_dims(ctx, "act_heads", h, p["wk"]) \
            if local_kv and not ctx.seq_fold else ()
        if kv_dims and all(q.placements[i].is_shard(2) for i in kv_dims):
            kv = LocalKV(cfg.num_kv_heads, lambda lo, hi: self._kv_block(
                p, h, pos, kv_dims, lo, hi))
            return q, kv, kv
        k, v = proj(p["wk"]), proj(p["wv"])
        if cfg.qkv_bias:
            k = k + p["bk"].to(dt)
            v = v + p["bv"].to(dt)
        k = apply_rope(k, pos, cfg.rope_theta)
        k = ctx.constrain(k, ("act_batch", None, "cache_heads", None))
        v = ctx.constrain(v, ("act_batch", None, "cache_heads", None))
        return q, k, v

    def _kv_block(self, p, h, pos, dims, lo, hi):
        """This rank's keys and values of KV heads ``[lo, hi)`` for its own
        rows, as local tensors: its rows of ``h`` (replicated over the mesh
        dimensions ``dims``, so each rank's gradient is a part of a pending
        sum) times its block of the replicated weights."""
        cfg = self.cfg
        dt = h.dtype
        roles = [None if i in dims else "batch" if pl.is_shard(0) else None
                 for i, pl in enumerate(h.placements)]
        hl = h.to_local(grad_placements=[
            Partial() if i in dims else pl
            for i, pl in enumerate(h.placements)])
        pl = to_shard(pos, h.device_mesh, roles, {"batch": 0})

        def block(w, b):
            wl = own_part(w.to(dt), 1, lo, hi - lo)
            out = (hl @ wl.reshape(wl.shape[0], -1)).reshape(
                *hl.shape[:2], hi - lo, cfg.head_dim)
            return out if b is None else out + own_part(b.to(dt), 0, lo,
                                                        hi - lo)

        bias = cfg.qkv_bias
        k = block(p["wk"], p["bk"] if bias else None)
        v = block(p["wv"], p["bv"] if bias else None)
        return apply_rope(k, pl, cfg.rope_theta), v

    def _attn_out(self, p, attn, dt, ctx=NULL_CTX):
        B, S = attn.shape[:2]
        wo = p["wo"].to(dt)
        split = split_dims(ctx, "act_heads", wo)
        out = row_split(attn, wo, split) if split else None
        if out is not None:  # each rank's own heads: a pending sum
            return out
        return attn.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])

    def _mlp(self, p, h, ctx):
        """Returns (output, router aux term or None for a dense MLP)."""
        cfg = self.cfg
        if cfg.moe is not None:
            return moe_lib.moe_ffn(h, p, "", cfg, ctx)
        return glu_mlp(h, p["w_gate"], p["w_up"], p["w_down"], cfg.mlp_act,
                       ctx), None

    def _layer_full(self, p, x, pos, ctx, want_kv=True):
        """Full-sequence layer (train / prefill). Returns (x, (k, v), aux),
        (k, v) None without ``want_kv``."""
        cfg = self.cfg
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        q, k, v = self._attn_proj_qkv(p, h, pos, ctx, local_kv=not want_kv)
        attn = blockwise_attention(
            q, k, v, pos, pos,
            causal=True, window=cfg.window, chunk=cfg.attn_chunk,
            fold=ctx.seq_fold,
        )
        x = x + self._attn_out(p, attn, x.dtype, ctx)
        x = ctx.constrain(x, ("act_batch", "act_seq", "act_embed"))
        h2 = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        mlp_out, aux = self._mlp(p, h2, ctx)
        x = ctx.constrain(x + mlp_out, ("act_batch", "act_seq", "act_embed"))
        return x, (k, v) if want_kv else None, aux

    def _layer_loss(self, p, x, pos, ctx):
        """``_layer_full`` without the K / V, on the weights' FSDP shards
        gathered: (x, aux)."""
        p = ctx.gather_fsdp(p, x.dtype, self.KEEP)
        x, _, aux = self._layer_full(p, x, pos, ctx, want_kv=False)
        return x, aux

    def _layer_decode(self, p, x, cache_k, cache_v, cache_pos, t, ctx):
        """Single-token layer. x: (B,1,D). Returns (x, new_k, new_v, pos)."""
        cfg = self.cfg
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        pos_q = t[:, None]  # (B,1)
        q, k, v = self._attn_proj_qkv(p, h, pos_q, ctx, decode=True)
        ck, cv, cp = cache_update(cache_k, cache_v, cache_pos, k, v, t)
        ck = ctx.constrain(ck, ("cache_batch", "cache_seq", "cache_heads", None))
        cv = ctx.constrain(cv, ("cache_batch", "cache_seq", "cache_heads", None))
        attn = decode_attention(q, ck, cv, pos_q, cp, window=cfg.window)
        x = x + self._attn_out(p, attn, x.dtype)
        h2 = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        return x + self._mlp(p, h2, ctx)[0], ck, cv, cp

    # ------------------------------------------------------------- embeddings
    def _embed_tokens(self, params, tokens, ctx):
        cfg = self.cfg
        dt = torch_dtype(cfg.compute_dtype)
        emb = params["tok_embed"].to(dt)
        x = embed_rows(emb, tokens)
        if cfg.tie_embeddings:  # gemma-style embed scaling
            x = x * scalar_in(np.sqrt(cfg.d_model), dt)
        return ctx.constrain(x, ("act_batch", "act_seq", "act_embed"))

    def _assemble_input(self, params, batch, ctx):
        """Token embeds (vocab-parallel on the loss path), with the VLM
        patch prefix when the batch has ``patches``.  Returns (x, labels),
        the labels (if any) padded with -1 on the patch positions."""
        cfg = self.cfg
        x = self._embed_tokens(params, batch["tokens"], ctx)
        labels = batch.get("labels")
        if labels is not None:
            labels = torch.as_tensor(labels, device=x.device)
        if cfg.family == "vlm" and "patches" in batch:
            dt = x.dtype
            patches = torch.as_tensor(batch["patches"], device=x.device)
            pe = rms_norm(patches.to(dt), params["patch_norm"], cfg.norm_eps)
            pe = pe @ params["patch_proj"].to(dt)
            # laid out as the token embeds: the projection can leave a sum
            # pending over "model", which every later norm would settle
            x = ctx.constrain(torch.cat([pe, x], dim=1),
                              ("act_batch", "act_seq", "act_embed"))
            if labels is not None:
                pad = torch.full(pe.shape[:2], -1, dtype=labels.dtype,
                                 device=x.device)
                labels = torch.cat([pad, labels], dim=1)
        return x, labels

    def _logits(self, params, x, ctx):
        """The LM head's logits, its FSDP shards gathered first (every
        path: with the vocabulary sharded, each rank's logits stay on its
        own vocabulary shard)."""
        dt = x.dtype
        head = (
            params["tok_embed"].to(dt).T
            if self.cfg.tie_embeddings
            else params["lm_head"].to(dt)
        )
        return ctx.constrain(head_logits(x, head, ctx),
                             ("act_batch", "act_seq", "act_vocab"))

    # ------------------------------------------------------------------ modes
    def _stack_full(self, params, x, pos, ctx, collect_kv: bool):
        """Returns (x, (ks, vs) or None, the layers' summed router aux
        term, or None for the dense family)."""
        S = x.shape[1]
        C = self.cache_len(S)  # SWA: keep only the trailing window
        ks, vs = [], []
        aux = None
        for i in range(self.cfg.num_layers):
            p_l = self._layer(params, i)
            if not collect_kv:  # the loss path: remat, as ``repro``
                x, aux_l = remat(self.cfg, self._layer_loss, p_l, x, pos,
                                 ctx)
            else:  # the FSDP shards gathered as the loss path's are:
                # each rank's own heads and MLP columns, not all of them
                x, (k, v), aux_l = self._layer_full(
                    ctx.gather_fsdp(p_l, x.dtype, self.KEEP), x, pos, ctx)
            if aux_l is not None:
                aux = aux_l if aux is None else aux + aux_l
            if collect_kv:
                ks.append(k[:, S - C:] if C < S else k)
                vs.append(v[:, S - C:] if C < S else v)
        kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
        return x, kvs, aux

    @staticmethod
    def _positions(x: torch.Tensor) -> torch.Tensor:
        return positions_like(x)

    def loss(self, params, batch, ctx: ShardingCtx = NULL_CTX):
        """Mean next-token cross entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (label -1 is ignored), plus the MoE family's
        ``router_aux_coef`` times the layers' summed router aux term;
        returns (loss, {"ce", "aux"})."""
        cfg = self.cfg
        x, labels = self._assemble_input(params, batch, ctx)
        pos = self._positions(x)
        # a dropping MoE forms its dispatch groups from the rows: folded,
        # its tokens would fall into other groups and other ones be dropped
        if not (cfg.moe and cfg.moe.impl == "dropping"):
            ctx = ctx.sequence_fold(x)
        if ctx.seq_fold:  # rows replicated over a row axis: fold them
            x, pos = (fold_rows(t, ctx.seq_fold) for t in (x, pos))
        x, _, aux = self._stack_full(params, x, pos, ctx, collect_kv=False)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x, ctx)
        ce = next_token_ce(logits, labels, ctx.seq_fold)
        if aux is None:
            return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}
        return ce + cfg.moe.router_aux_coef * aux, {"ce": ce, "aux": aux}

    forward = loss

    def prefill(self, params, batch, ctx: ShardingCtx = NULL_CTX,
                capacity: Optional[int] = None):
        """capacity: total positions the cache must hold (prompt + planned
        new tokens); defaults to the prompt length.  Returns (last-position
        logits (B, V), cache)."""
        cfg = self.cfg
        x, _ = self._assemble_input(params, batch, ctx)
        S = x.shape[1]
        pos = self._positions(x)
        x, (ks, vs), _ = self._stack_full(params, x, pos, ctx, collect_kv=True)
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x, ctx)[:, 0]
        return logits, self._cache_from_prefill(ks, vs, pos, S, capacity)

    def _cache_from_prefill(self, ks, vs, pos, S, capacity=None):
        """ks, vs: (L, B, C', Hkv, hd) with C' = min(S, cache_len(S))."""
        C = self.cache_len(max(capacity or S, S))
        if C > S:  # headroom for decode: empty slots marked pos = -1
            pad = (0, 0, 0, 0, 0, C - S)
            ks = torch.nn.functional.pad(ks, pad)
            vs = torch.nn.functional.pad(vs, pad)
            cache_pos = torch.nn.functional.pad(pos, (0, C - S), value=-1)
            return {"k": ks, "v": vs, "pos": cache_pos.to(torch.int32)}
        if C < S:  # SWA rolling buffer keeps the trailing window
            # slot for position p is p % C; trailing window is a rotation,
            # gathered on the device: slot j holds the tail's entry
            # (j - shift) % C, shift = the tail's first position % C
            ks, vs = ks[:, :, -C:], vs[:, :, -C:]
            pos_tail = pos[:, -C:]
            slots = torch.arange(C, device=pos.device)
            src = (slots - (pos_tail[:, :1] % C).long()) % C      # (B, C)
            idx = src[None, :, :, None, None].expand(ks.shape)
            ks, vs = ks.gather(2, idx), vs.gather(2, idx)
            cache_pos = pos_tail.gather(1, src)
        else:
            cache_pos = pos
        return {"k": ks, "v": vs, "pos": cache_pos.to(torch.int32)}

    def cache_len(self, seq_len: int) -> int:
        cfg = self.cfg
        return min(seq_len, cfg.window) if cfg.window else seq_len

    def cache_specs(self, batch: int, seq_len: int) -> Dict[str, TensorSpec]:
        cfg = self.cfg
        C = self.cache_len(seq_len)
        kv = TensorSpec(
            (cfg.num_layers, batch, C, cfg.num_kv_heads, cfg.head_dim),
            torch_dtype(cfg.compute_dtype),
        )
        return {"k": kv, "v": kv, "pos": TensorSpec((batch, C), torch.int32)}

    def decode(self, params, tokens, cache, t, ctx: ShardingCtx = NULL_CTX):
        """tokens: (B,1); t: (B,) current position. Returns (logits, cache)."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens, ctx)
        cache_pos = cache["pos"]
        ks, vs = new_layers_like(cache["k"]), new_layers_like(cache["v"])
        for i in range(cfg.num_layers):
            x, ks[i], vs[i], cache_pos = self._layer_decode(
                self._layer(params, i), x, cache["k"][i], cache["v"][i],
                cache_pos, t, ctx)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x, ctx)[:, 0]
        return logits, {"k": ks, "v": vs, "pos": cache_pos}
