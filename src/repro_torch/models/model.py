"""Model factory and concrete inputs (counterpart of ``repro.models.model``).

The port builds the dense family (``DecoderLM``); every other family raises
and names the ROADMAP item that ports it.  ``make_inputs`` draws the same
token batches as ``repro``'s from the same seed; ``make_cache`` is a zero
cache with ``filled`` valid positions.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.transformer import DecoderLM

# family -> where ROADMAP A6 ports it
_NOT_PORTED = {
    "moe": "ROADMAP A6: MoE (models/moe.py) comes next",
    "hybrid": "ROADMAP A6: hybrid / SSM / RWKV follow MoE",
    "ssm": "ROADMAP A6: hybrid / SSM / RWKV follow MoE",
    "audio": "ROADMAP A6: the enc-dec audio model follows the SSM family",
    "vlm": "ROADMAP A6: the VLM patch prefix comes after enc-dec",
}


def build_model(cfg: ModelConfig):
    if cfg.family == "dense":
        return DecoderLM(cfg)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"build_model: family {cfg.family!r} ({cfg.name}) is not ported "
            f"yet ({_NOT_PORTED[cfg.family]})")
    raise ValueError(cfg.family)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, tuple]:
    """name -> shape of each int32 input of a dense-family cell."""
    build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": (B, S), "labels": (B, S)}
    if shape.kind == "prefill":
        return {"tokens": (B, S)}
    if shape.kind == "decode":
        return {"tokens": (B, 1)}
    raise ValueError(shape.kind)


def make_inputs(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Concrete small token batches matching ``batch_specs``, drawn as
    ``repro``'s are (one ``default_rng(seed)``, in spec order)."""
    rng = np.random.default_rng(seed)
    return {
        k: torch.as_tensor(
            rng.integers(0, cfg.vocab_size, size=s, dtype=np.int32),
            device=device)
        for k, s in batch_specs(cfg, shape).items()
    }


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
        else:
            cache[k] = torch.zeros(s.shape, dtype=s.dtype, device=device)
    return cache
