"""gemma-2b [dense] — GeGLU, head_dim=256, MQA. [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ModelConfig, reduced_common

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,  # MQA
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_act="geglu",
    rope_theta=10000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return reduced_common(CONFIG, num_kv_heads=1, tie_embeddings=True)
