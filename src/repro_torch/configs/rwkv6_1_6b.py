"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free.
[arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig, reduced_common

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,  # wkv heads = d_model / head_dim
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
)


def reduced() -> ModelConfig:
    return reduced_common(CONFIG, num_heads=4, num_kv_heads=4)
