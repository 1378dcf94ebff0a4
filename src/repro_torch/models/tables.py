"""Parameter tables of the families the port does not run yet: hybrid
(``repro.models.hybrid.HybridLM`` with ``repro.models.ssm``'s Mamba
table), RWKV (``repro.models.rwkv.RWKVLM``) and enc-dec
(``repro.models.encdec.EncDecLM``), copied name for name and shape for
shape.

``models.model.active_param_count`` and ``model_flops_per_step`` count
parameters from these, so the analytic counts cover every configuration;
the models that use them come with ROADMAP A6's next slices.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec

TMIX_LORA = 32
DECAY_LORA = 64


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


def hybrid_param_table(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, Hkv, hd, ff, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim, cfg.d_ff, cfg.vocab_size)
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


def rwkv_param_table(cfg: ModelConfig) -> Dict[str, ParamSpec]:
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
        "mu_5": ParamSpec(lead + (5, d), lx + ("stack", "norm"), init="zeros"),
        "tmix_w1": ParamSpec(lead + (d, 5 * TMIX_LORA), lx + ("embed", None)),
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
