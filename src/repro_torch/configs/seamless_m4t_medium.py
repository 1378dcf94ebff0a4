"""seamless-m4t-medium [audio] — enc-dec transformer backbone; the speech
frontend is a STUB (input_specs provides precomputed frame embeddings).
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig, reduced_common

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,  # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
)


def reduced() -> ModelConfig:
    return reduced_common(CONFIG)
