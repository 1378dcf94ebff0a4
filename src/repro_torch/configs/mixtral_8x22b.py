"""mixtral-8x22b [moe] — 8 experts top-2, SWA. [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, MoESpec, reduced_common

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    rope_theta=1_000_000.0,
    window=4096,  # SWA rolling-buffer window
    moe=MoESpec(num_experts=8, experts_per_token=2),
)


def reduced() -> ModelConfig:
    return reduced_common(CONFIG)
