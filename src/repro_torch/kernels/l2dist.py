"""Squared-L2 distance matrix kernel: (Q, d) × (C, d) → (Q, C).

Replaces ``repro.kernels.l2dist.l2dist`` (Pallas).  The CUDA source is
``csrc/l2dist.cu``; its header says what bounds it on an H100 and what the
design does about it: rows of a multiple of 16 bytes on 16-byte aligned
bases take an fp32 SIMT SGEMM (128 × 128 tiles, 8 × 8 micro-tiles, a
3-stage cp.async ring) with the distance epilogue fused; any other width or
view takes a tiled kernel.  Both give the same bits, on a 1-D grid of
tiles.  ``plan`` is the launch the source computes from the shapes, dtype
and alignment.  On CPU tensors, or with ``interpret=True``, the wrapper
runs the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCH = {"l2dist": [_P, _P, _P, _I, _I, _I, _I, _P]}
_FUNCTIONS = {**_LAUNCH,
              "l2dist_plan": [_P, _P, _I, _I, _I, _I, ctypes.POINTER(_I)]}
_PLAN_KEYS = ("path", "tile_q", "tile_c", "grid", "smem")
_PATHS = ("tiled", "sgemm")
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID = 2**31 - 1   # blocks of a 1-D grid
_MAX_INT = 2**31 - 1    # Q, C and d are C ints


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(Q: int, C: int, d: int, *, bf16: bool = False,
         aligned: bool = True) -> dict:
    """The launch ``csrc/l2dist.cu`` makes: ``sgemm`` (128 × 128 tiles; d a
    multiple of 16 bytes' worth of elements, 16-byte aligned bases) or
    ``tiled`` (64 × 64), ``grid`` tiles on a 1-D grid (-1 past 2³¹ − 1),
    ``smem`` bytes of dynamic shared memory (3 stages of two 128-row
    chunks of 32 at a row stride of 36 floats or 40 bf16, and the norms)."""
    sgemm = d > 0 and d % (8 if bf16 else 4) == 0 and aligned
    tile = 128 if sgemm else 64
    grid = _cdiv(Q, tile) * _cdiv(C, tile)
    smem = 0
    if sgemm:
        smem = 3 * 2 * 128 * (40 * 2 if bf16 else 36 * 4) + 2 * 128 * 4
    return {"path": "sgemm" if sgemm else "tiled", "tile_q": tile,
            "tile_c": tile, "grid": grid if grid <= _MAX_GRID else -1,
            "smem": smem}


def _lib():
    return _build.load("l2dist", _FUNCTIONS)


def cuda_plan(q, c) -> dict:
    """The plan the built source computes for these CUDA tensors."""
    out = (_I * len(_PLAN_KEYS))()
    lib = _lib()
    err = lib.l2dist_plan(_build.ptr(q), _build.ptr(c), q.shape[0], c.shape[0],
                          q.shape[1], int(q.dtype == torch.bfloat16), out)
    _build.check(lib, err, "l2dist_plan")
    rec = dict(zip(_PLAN_KEYS, out))
    rec["path"] = _PATHS[rec["path"]]
    return rec


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
    bf16 = q.dtype == torch.bfloat16
    aligned = q.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0
    if max(Q, C, d) > _MAX_INT or plan(Q, C, d, bf16=bf16,
                                       aligned=aligned)["grid"] < 0:
        raise ValueError(f"l2dist: ({Q}, {C}, {d}) exceeds the 1-D grid's "
                         f"{_MAX_GRID:,} tiles or a C int")
    out = torch.empty((Q, C), dtype=torch.float32, device=q.device)
    if Q * C == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.l2dist(
            _build.ptr(q), _build.ptr(c), _build.ptr(out), Q, C, d,
            int(bf16), _build.stream_of(q),
        )
    _build.check(lib, err, "l2dist")
    l2dist.launches += 1
    return out


l2dist.launches = 0
