"""Architecture registry: ``--arch <id>`` resolves through ``get_config``."""
from __future__ import annotations

from repro_torch.configs import (
    gemma_2b,
    internvl2_26b,
    llama3_8b,
    mistral_large_123b,
    mixtral_8x22b,
    qwen2_5_32b,
    qwen2_moe_a2_7b,
    rwkv6_1_6b,
    seamless_m4t_medium,
    zamba2_1_2b,
)
from repro_torch.configs.base import (
    LM_SHAPES,
    SHAPES,
    ModelConfig,
    MoESpec,
    ShapeSpec,
    shape_applicable,
)

_MODULES = {
    "mixtral-8x22b": mixtral_8x22b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "mistral-large-123b": mistral_large_123b,
    "gemma-2b": gemma_2b,
    "llama3-8b": llama3_8b,
    "qwen2.5-32b": qwen2_5_32b,
    "zamba2-1.2b": zamba2_1_2b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "internvl2-26b": internvl2_26b,
    "seamless-m4t-medium": seamless_m4t_medium,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return _MODULES[name].CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _MODULES[name].reduced()


__all__ = [
    "ARCH_NAMES",
    "LM_SHAPES",
    "SHAPES",
    "ModelConfig",
    "MoESpec",
    "ShapeSpec",
    "get_config",
    "get_reduced",
    "shape_applicable",
]
