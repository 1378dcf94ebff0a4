"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig, reduced_common

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,  # Mamba2 blocks
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,  # shared attention block is MHA
    head_dim=64,
    d_ff=8192,  # shared block MLP hidden
    vocab_size=32000,
    ssm_state=64,
    mamba_headdim=64,
    mamba_expand=2,
    conv_kernel=4,
    attn_every=6,  # shared transformer block applied every 6 Mamba2 blocks
    scan_layers=False,  # interleaved shared block breaks layer homogeneity
)


def reduced() -> ModelConfig:
    return reduced_common(CONFIG, num_layers=4, num_kv_heads=4)
