"""LM stack (counterpart of ``repro.models``): the dense, MoE and VLM
decoders so far."""
from repro_torch.models.model import build_model, make_cache, make_inputs
from repro_torch.models.transformer import DecoderLM

__all__ = ["DecoderLM", "build_model", "make_cache", "make_inputs"]
