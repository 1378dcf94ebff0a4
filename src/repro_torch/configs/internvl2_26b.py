"""internvl2-26b [vlm] — InternLM2-20B language backbone; InternViT frontend is
a STUB (input_specs provides precomputed patch embeddings). [arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig, reduced_common

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    num_patches=1024,  # image-token prefix (256 per tile x 4 tiles)
    patch_dim=3200,  # InternViT-6B output width (projected by mlp1 stub)
)


def reduced() -> ModelConfig:
    return reduced_common(CONFIG)
