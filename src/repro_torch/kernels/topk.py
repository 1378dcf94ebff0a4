"""Small-k selection kernel: the k smallest of each row, ascending.

Replaces ``repro.kernels.topk.topk_min`` (Pallas).  The CUDA source is
``csrc/topk.cu``; its header says what bounds it on an H100 and what the
design does about it.  On CPU tensors, or with ``interpret=True``, the
wrapper runs the plain version in ``kernels.ref`` (a stable sort).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_FUNCTIONS = {"topk_min_f32": [_P, _P, _P, _I, _I, _I, _P]}


def topk_min(d, k: int, *, interpret: bool = False):
    """(B, C) → (values (B, k) float32 ascending, indices (B, k) int32).

    Ties go to the lowest index; 3.4e38 is an ordinary value.  Needs
    ``1 <= k <= C``."""
    if d.dim() != 2:
        raise ValueError(f"topk_min: need (B, C), got {tuple(d.shape)}")
    B, C = d.shape
    if not 1 <= k <= C:
        raise ValueError(f"topk_min: need 1 <= k <= C, got k={k}, C={C}")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"topk_min: unsupported device {d.device}")
    if interpret or d.device.type == "cpu":
        return ref.topk_min_ref(d, k)
    x = d.to(torch.float32).contiguous()
    vals = torch.empty((B, k), dtype=torch.float32, device=d.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=d.device)
    if B == 0:
        return vals, idx
    lib = _build.load("topk", _FUNCTIONS)
    with torch.cuda.device(d.device):
        err = lib.topk_min_f32(
            _build.ptr(x), _build.ptr(vals), _build.ptr(idx), B, C, k,
            _build.stream_of(x),
        )
    _build.check(lib, err, "topk_min")
    topk_min.launches += 1
    return vals, idx


topk_min.launches = 0
