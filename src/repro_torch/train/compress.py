"""Gradient compression: per-tensor int8 with error feedback (counterpart
of ``repro.train.compress``'s single-process functions).

  1. int8 quantize with a per-tensor scale  s = max|g| / 127, rounding half
     to even (``jnp.round``'s rule; ``torch.round`` has it too);
  2. error feedback:  sent = Q(g + e);  e' = (g + e) − deQ(sent), so the
     quantization residual re-enters the next step's gradient.

``repro``'s ``cross_pod_grad_sync`` (the int8 all-gather over the "pod"
axis under ``shard_map``) comes with the sharding slice on
``torch.distributed`` (ROADMAP A7).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns (q, scale)."""
    gf = g.to(torch.float32)
    scale = torch.clamp_min(gf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback compression step: returns (q, scale, new_err)."""
    corrected = g.to(torch.float32) + err
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def init_error_state(params: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}
