"""Parameter table of the family the port does not run yet: enc-dec
(``repro.models.encdec.EncDecLM``), copied name for name and shape for
shape.

``models.model.active_param_count`` and ``model_flops_per_step`` count
parameters from it, so the analytic counts cover every configuration;
the model that uses it comes with ROADMAP A6's next slice.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec


def encdec_param_table(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, hd, ff, V = (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff,
                       cfg.vocab_size)
    Hkv = cfg.num_kv_heads
    t: Dict[str, ParamSpec] = {
        "tok_embed": ParamSpec((V, d), ("vocab", "embed"), scale=0.02),
        "enc_final_norm": ParamSpec((d,), ("norm",), init="zeros"),
        "final_norm": ParamSpec((d,), ("norm",), init="zeros"),
        "lm_head": ParamSpec((d, V), ("embed", "vocab")),
    }

    def attn_block(prefix, lead, lax_):
        return {
            f"{prefix}attn_norm": ParamSpec(lead + (d,), lax_ + ("norm",),
                                            init="zeros"),
            f"{prefix}wq": ParamSpec(lead + (d, H, hd),
                                     lax_ + ("embed", "heads", "head_dim")),
            f"{prefix}wk": ParamSpec(lead + (d, Hkv, hd),
                                     lax_ + ("embed", "kv_heads", "head_dim")),
            f"{prefix}wv": ParamSpec(lead + (d, Hkv, hd),
                                     lax_ + ("embed", "kv_heads", "head_dim")),
            f"{prefix}wo": ParamSpec(lead + (H, hd, d),
                                     lax_ + ("heads", "head_dim", "embed")),
        }

    def mlp_block(prefix, lead, lax_):
        return {
            f"{prefix}mlp_norm": ParamSpec(lead + (d,), lax_ + ("norm",),
                                           init="zeros"),
            f"{prefix}w_gate": ParamSpec(lead + (d, ff), lax_ + ("embed", "ff")),
            f"{prefix}w_up": ParamSpec(lead + (d, ff), lax_ + ("embed", "ff")),
            f"{prefix}w_down": ParamSpec(lead + (ff, d), lax_ + ("ff", "embed")),
        }

    le, ld = (cfg.encoder_layers,), (cfg.num_layers,)
    lax_ = ("layers",)
    t.update(attn_block("enc/", le, lax_))
    t.update(mlp_block("enc/", le, lax_))
    t.update(attn_block("dec/", ld, lax_))
    t.update(attn_block("dec/x", ld, lax_))  # cross-attention
    t.update(mlp_block("dec/", ld, lax_))
    return t
