"""qwen2.5-32b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5-32B family]"""
from repro_torch.configs.base import ModelConfig, reduced_common

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return reduced_common(CONFIG)
