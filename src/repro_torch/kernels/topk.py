"""Small-k selection kernel: the k smallest of each row, ascending.

Replaces ``repro.kernels.topk.topk_min`` (Pallas).  The CUDA source is
``csrc/topk.cu``; its header says what bounds it on an H100 (reading the
rows) and what the design does about it: for k ≤ 32 each row is read once,
in 16-byte loads, and each warp keeps its 32 smallest keys across its lanes
behind a threshold, the few keys below it buffered and merged in batches;
larger k take the first design's k passes over the row.  Both give the same bits.  ``plan`` is the
launch the source computes from (B, C, k).  On CPU tensors, or with
``interpret=True``, the wrapper runs the plain version in ``kernels.ref``
(a stable sort).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCH = {"topk_min_f32": [_P, _P, _P, _I, _I, _I, _P]}
_FUNCTIONS = {**_LAUNCH, "topk_plan": [_I, _I, _I, ctypes.POINTER(_I)]}
_PLAN_KEYS = ("path", "threads", "smem", "grid")
_PATHS = ("passes", "select")

# the source's constants: the select path takes k ≤ 32 (one key a lane of a
# warp list) on blocks of 32-128 threads, with a 64-bit list slot a thread
# and a buffer of 256 64-bit keys a warp in shared memory; the pass path
# runs 256 threads and stages rows of up to 40 KB of 32-bit keys
_CAP = 32
_SELECT_THREADS = 128
_BUF = 256
_THREADS = 256
_STAGE_BYTES = 40 * 1024


def plan(B: int, C: int, k: int) -> dict:
    """The launch ``csrc/topk.cu`` makes for (B, C) rows and k.

    ``select`` (k ≤ 32): one block a row of ``threads``, the least power
    of two from 32 that gives each thread at most four elements, capped at
    128; ``smem`` the warps' lists (8 bytes a thread) and buffers (256
    keys of 8 bytes a warp).  ``passes`` (k > 32): 256 threads a row,
    ``smem`` the row's 32-bit keys when they fit in 40 KB, else 0 (the row
    is read from device memory each pass)."""
    if k <= _CAP:
        threads = 32
        while threads < _SELECT_THREADS and threads < -(-C // 4):
            threads *= 2
        return {"path": "select", "threads": threads,
                "smem": 8 * (threads + threads // 32 * _BUF), "grid": B}
    row_bytes = 4 * C
    return {"path": "passes", "threads": _THREADS,
            "smem": row_bytes if row_bytes <= _STAGE_BYTES else 0, "grid": B}


def _lib():
    return _build.load("topk", _FUNCTIONS)


def cuda_plan(d, k: int) -> dict:
    """The plan the built source computes for this (B, C) tensor and k."""
    out = (_I * len(_PLAN_KEYS))()
    lib = _lib()
    err = lib.topk_plan(d.shape[0], d.shape[1], k, out)
    _build.check(lib, err, "topk_plan")
    rec = dict(zip(_PLAN_KEYS, out))
    rec["path"] = _PATHS[rec["path"]]
    return rec


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
    lib = _lib()
    with torch.cuda.device(d.device):
        err = lib.topk_min_f32(
            _build.ptr(x), _build.ptr(vals), _build.ptr(idx), B, C, k,
            _build.stream_of(x),
        )
    _build.check(lib, err, "topk_min")
    topk_min.launches += 1
    return vals, idx


topk_min.launches = 0
