"""Tiled squared-L2 distance matrix kernel: (Q, d) × (C, d) → (Q, C).

Replaces ``repro.kernels.l2dist.l2dist`` (Pallas).  The CUDA source is
``csrc/l2dist.cu``; its header says what bounds it on an H100 and what the
design does about it.  On CPU tensors, or with ``interpret=True``, the
wrapper runs the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_FUNCTIONS = {"l2dist": [_P, _P, _P, _I, _I, _I, _I, _P]}
_DTYPES = (torch.float32, torch.bfloat16)


def l2dist(q, c, *, interpret: bool = False):
    """(Q, d) × (C, d) → (Q, C) squared L2 ``max(‖q‖² − 2q·c + ‖c‖², 0)``,
    fp32 out; q and c are both float32 or both bfloat16."""
    if q.dim() != 2 or c.dim() != 2 or q.shape[1] != c.shape[1]:
        raise ValueError(
            f"l2dist: need (Q, d) and (C, d), got {tuple(q.shape)} and "
            f"{tuple(c.shape)}"
        )
    if q.dtype != c.dtype or q.dtype not in _DTYPES:
        raise ValueError(
            f"l2dist: q and c must both be float32 or bfloat16, got "
            f"{q.dtype} and {c.dtype}"
        )
    if q.device != c.device or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"l2dist: q on {q.device}, c on {c.device}")
    if interpret or q.device.type == "cpu":
        return ref.l2dist_ref(q, c)
    if not (q.is_contiguous() and c.is_contiguous()):
        raise ValueError("l2dist: q and c must be contiguous")
    Q, d = q.shape
    C = c.shape[0]
    if (C + 63) // 64 > 65535:
        raise ValueError(f"l2dist: C={C} exceeds the grid's 65,535 column tiles")
    out = torch.empty((Q, C), dtype=torch.float32, device=q.device)
    if Q * C == 0:
        return out
    lib = _build.load("l2dist", _FUNCTIONS)
    with torch.cuda.device(q.device):
        err = lib.l2dist(
            _build.ptr(q), _build.ptr(c), _build.ptr(out), Q, C, d,
            int(q.dtype == torch.bfloat16), _build.stream_of(q),
        )
    _build.check(lib, err, "l2dist")
    l2dist.launches += 1
    return out


l2dist.launches = 0
