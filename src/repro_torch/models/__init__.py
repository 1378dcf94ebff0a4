"""LM stack (counterpart of ``repro.models``): the dense, MoE and VLM
decoders, the zamba2 hybrid, RWKV-6 and the enc-dec audio model."""
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.model import build_model, make_cache, make_inputs
from repro_torch.models.rwkv import RWKVLM
from repro_torch.models.transformer import DecoderLM

__all__ = ["DecoderLM", "EncDecLM", "HybridLM", "RWKVLM", "build_model",
           "make_cache", "make_inputs"]
