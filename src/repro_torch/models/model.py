"""Model factory, input specs and analytic counts (counterpart of
``repro.models.model``).

The port builds every family of ``repro``: the dense, MoE and VLM
decoders (``DecoderLM``), the hybrid (``HybridLM``), RWKV (``RWKVLM``)
and the enc-dec audio model (``EncDecLM``).  ``make_inputs`` draws the
same batches as ``repro``'s from the same seed; ``make_cache`` is a zero
cache with ``filled`` valid positions (a state with no ``pos``, as
RWKV's, is all zeros; the enc-dec's ``enc_pos`` counts up).
``active_param_count`` and ``model_flops_per_step`` are ``repro``'s
formulas, pure Python, over every family's parameter table.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.common import torch_dtype
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.rwkv import RWKVLM
from repro_torch.models.transformer import FAMILIES, DecoderLM, TensorSpec


def build_model(cfg: ModelConfig):
    if cfg.family in FAMILIES:
        return DecoderLM(cfg)
    if cfg.family == "audio":
        return EncDecLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    if cfg.family == "ssm":
        return RWKVLM(cfg)
    raise ValueError(cfg.family)


def _i32(*shape) -> TensorSpec:
    return TensorSpec(shape, torch.int32)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, TensorSpec]:
    """Specs of the *batch* argument: tokens / labels; the VLM's
    precomputed patch embeddings in the compute dtype, which take the
    first ``num_patches`` of the cell's ``seq_len`` positions; the audio
    family's frame embeddings (B, S, d_model) in the compute dtype, with a
    decoder prompt of ``min(S, 128)`` tokens at prefill."""
    build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.compute_dtype)
    out: Dict[str, TensorSpec] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            P = cfg.num_patches
            out["patches"] = TensorSpec((B, P, cfg.patch_dim), dt)
            S -= P
        elif cfg.family == "audio":
            out["frames"] = TensorSpec((B, S, cfg.d_model), dt)
            if shape.kind == "prefill":
                S = min(S, 128)  # the decoder prompt
        out["tokens"] = _i32(B, S)
        if shape.kind == "train":
            out["labels"] = _i32(B, S)
        return out
    if shape.kind == "decode":
        return {"tokens": _i32(B, 1)}
    raise ValueError(shape.kind)


def serve_state_specs(cfg: ModelConfig, shape: ShapeSpec):
    """(cache specs, t spec) for decode cells."""
    cache = build_model(cfg).cache_specs(shape.global_batch, shape.seq_len)
    return cache, _i32(shape.global_batch)


def make_inputs(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Concrete small inputs matching ``batch_specs``, drawn as ``repro``'s
    are (one ``default_rng(seed)``, in spec order: integers for the int32
    specs, ``standard_normal`` float32 for the others)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in batch_specs(cfg, shape).items():
        if s.dtype == torch.int32:
            a = rng.integers(0, cfg.vocab_size, size=s.shape, dtype=np.int32)
            out[k] = torch.as_tensor(a, device=device)
        else:
            a = rng.standard_normal(s.shape).astype(np.float32)
            out[k] = torch.as_tensor(a, device=device).to(s.dtype)
    return out


def make_cache(cfg: ModelConfig, batch: int, seq_len: int, filled: int = 0,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Concrete zero-initialized cache with `filled` valid positions."""
    specs = build_model(cfg).cache_specs(batch, seq_len)
    cache = {}
    for k, s in specs.items():
        if k == "pos":
            pos = np.full(s.shape, -1, np.int32)
            pos[:, :filled] = np.arange(filled)[None, :]
            cache[k] = torch.as_tensor(pos, device=device)
        elif k == "enc_pos":
            cache[k] = torch.as_tensor(np.broadcast_to(
                np.arange(s.shape[1], dtype=np.int32), s.shape).copy(),
                device=device)
        else:
            cache[k] = torch.zeros(s.shape, dtype=s.dtype, device=device)
    return cache


def model_flops_per_step(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Analytic MODEL_FLOPS: 6·N·D (dense) / 6·N_active·D (MoE) for
    training, 2·N_active per token for inference, + attention term."""
    n_active = active_param_count(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        toks = B * S
        flops = 6.0 * n_active * toks
        # attention scores+values: 12·B·S²·H·hd per layer fwd+bwd (causal ≈ /2)
        S_eff = min(S, cfg.window) if cfg.window else S
        flops += 6.0 * 2 * B * S * S_eff * cfg.num_heads * cfg.head_dim \
            * _attn_layer_count(cfg) * 0.5
        return flops
    if shape.kind == "prefill":
        toks = B * S
        S_eff = min(S, cfg.window) if cfg.window else S
        flops = 2.0 * n_active * toks
        flops += 2.0 * 2 * B * S * S_eff * cfg.num_heads * cfg.head_dim \
            * _attn_layer_count(cfg) * 0.5
        return flops
    # decode: one token; attention reads the whole cache
    C = min(S, cfg.window) if cfg.window else S
    if cfg.family == "ssm":
        C = 0  # constant-size state
    flops = 2.0 * n_active * B
    flops += 2.0 * 2 * B * C * cfg.num_heads * cfg.head_dim \
        * _attn_layer_count(cfg)
    return flops


def _attn_layer_count(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers  # self+cross
    return cfg.num_layers


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE counts top-k + shared experts only)."""
    table = build_model(cfg).param_table()
    total = 0
    for name, spec in table.items():
        n = int(np.prod(spec.shape))
        if name in ("we_gate", "we_up", "we_down") and cfg.moe:
            n = n // cfg.moe.num_experts * cfg.moe.experts_per_token
        total += n
    return total
