"""Fused normalize + cosine-score kernel (GATE entry selection).

Replaces ``repro.kernels.twotower_score.twotower_score`` (Pallas).  The CUDA
source is ``csrc/twotower_score.cu``; its header says what bounds it on an
H100 and what the design does about it.  On CPU tensors, or with
``interpret=True``, the wrapper runs the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_FUNCTIONS = {"twotower_score_f32": [_P, _P, _P, _I, _I, _I, _P]}


def twotower_score(q, h, *, interpret: bool = False):
    """(B, d) query latents × (H, d) hub latents → (B, H) cosine, fp32."""
    if q.dim() != 2 or h.dim() != 2 or q.shape[1] != h.shape[1]:
        raise ValueError(
            f"twotower_score: need (B, d) and (H, d), got "
            f"{tuple(q.shape)} and {tuple(h.shape)}"
        )
    if q.dtype != torch.float32 or h.dtype != torch.float32:
        raise ValueError("twotower_score: q and h must be float32")
    if q.device != h.device or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"twotower_score: q on {q.device}, h on {h.device}")
    if interpret or q.device.type == "cpu":
        return ref.twotower_score_ref(q, h)
    if not (q.is_contiguous() and h.is_contiguous()):
        raise ValueError("twotower_score: q and h must be contiguous")
    B, d = q.shape
    H = h.shape[0]
    out = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if B * H == 0:
        return out
    lib = _build.load("twotower_score", _FUNCTIONS)
    with torch.cuda.device(q.device):
        err = lib.twotower_score_f32(
            _build.ptr(q), _build.ptr(h), _build.ptr(out), B, H, d,
            _build.stream_of(q),
        )
    _build.check(lib, err, "twotower_score")
    twotower_score.launches += 1
    return out


twotower_score.launches = 0
