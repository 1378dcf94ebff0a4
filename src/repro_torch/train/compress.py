"""Gradient compression for the cross-pod hop: per-tensor int8 with error
feedback (counterpart of ``repro.train.compress``).

  1. int8 quantize with a per-tensor scale  s = max|g| / 127, rounding half
     to even (``jnp.round``'s rule; ``torch.round`` has it too);
  2. error feedback:  sent = Q(g + e);  e' = (g + e) − deQ(sent), so the
     quantization residual re-enters the next step's gradient.

``cross_pod_grad_sync`` runs on every rank of a mesh, with each rank's
gradients already reduced within its pod: it all-gathers the int8 payload
and the scales over the mesh's "pod" dimension (its process group,
``mesh.get_group(axis)``) and sums the dequantized payloads locally.
With P pods that link carries P·B/4 bytes against 2·B for a float32 ring
all-reduce.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist


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


def cross_pod_grad_sync(grads: Dict[str, torch.Tensor],
                        err_state: Dict[str, torch.Tensor], mesh, *,
                        axis: str = "pod"):
    """int8 all-gather cross-pod gradient averaging with error feedback,
    over ``mesh``'s ``axis`` dimension.  ``grads`` / ``err_state``: this
    rank's (per-pod) gradients and residuals by name.  Returns (synced
    grads, new err_state), the synced leaves in each gradient's dtype."""
    group = mesh.get_group(axis)
    n_pods = dist.get_world_size(group)
    synced, new_err = {}, {}
    for name in sorted(grads):
        g = grads[name]
        q, scale, new_err[name] = ef_compress(g, err_state[name])
        qs = [torch.empty_like(q) for _ in range(n_pods)]
        ss = [torch.empty_like(scale) for _ in range(n_pods)]
        dist.all_gather(qs, q.contiguous(), group=group)
        dist.all_gather(ss, scale.reshape(()).contiguous(), group=group)
        # repro's tensordot of the (P,) scales with the (P, ...) payloads
        summed = torch.tensordot(torch.stack(ss).to(torch.float32),
                                 torch.stack(qs).to(torch.float32), dims=1)
        synced[name] = (summed / n_pods).to(g.dtype)
    return synced, new_err
