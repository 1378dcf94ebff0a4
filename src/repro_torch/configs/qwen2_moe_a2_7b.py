"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4. [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.configs.base import ModelConfig, MoESpec, reduced_common

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,  # per-expert FFN hidden (moe_intermediate_size)
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=MoESpec(
        num_experts=60,
        experts_per_token=4,
        shared_experts=4,
        expert_d_ff=1408,
        shared_d_ff=5632,
    ),
)


def reduced() -> ModelConfig:
    return reduced_common(CONFIG)
