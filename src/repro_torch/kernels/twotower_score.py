"""Fused normalize + cosine-score kernel (GATE entry selection).

Replaces ``repro.kernels.twotower_score.twotower_score`` (Pallas).  The CUDA
source is ``csrc/twotower_score.cu``; its header says what bounds it on an
H100 and what the design does about it: at the main path's shapes (up to
128 hubs of width up to 128, rows a multiple of 16 bytes) the hub matrix
stays in shared memory, loaded once per cluster of 4 blocks, while
persistent blocks stream query tiles through a two-stage bulk-copy ring;
any other shape takes a tiled kernel.  Both give the same bits.  ``plan``
is the launch plan the source computes from the shapes, the alignment and
the card's SM count.  On CPU tensors, or with
``interpret=True``, the wrapper runs the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCH = {"twotower_score_f32": [_P, _P, _P, _I, _I, _I, _P]}
_FUNCTIONS = {**_LAUNCH,
              "twotower_score_plan": [_P, _P, _I, _I, _I, ctypes.POINTER(_I)]}
_PLAN_KEYS = ("path", "tb", "grid", "smem", "gp_log", "ri", "threads")
_PATHS = ("tiled", "resident")

# the source's constants: the resident path holds at most 128 hubs of width
# 128; its shared memory is a head (3 mbarriers, the hub scales, two
# stages' query-row scales), the hub rows and two stages of query rows at a
# stride of 4 (mod 8) floats; an SM has 228 KB
_MAX_H = _MAX_D = 128
_TILE = 64
_HEAD = 32 + 4 * _MAX_H + 2 * 4 * 64
_CLUSTER = 4
_SMEM_PER_SM = 233472
_MAX_GRID_Y = 65535


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, H: int, d: int, *, aligned: bool = True,
         n_sm: int = 132) -> dict:
    """The launch ``csrc/twotower_score.cu`` makes for (B, d) × (H, d) with
    16-byte aligned bases (``aligned``) on a card of ``n_sm`` SMs.

    ``resident`` (H ≤ 128, d ≤ 128, both multiples of 4, aligned): query
    tiles of ``tb`` rows, 64 halved while there are fewer than 2 tiles a SM
    (down to 16); blocks of ``threads`` (a warp covers up to 4 hub groups of
    4 hubs for 8 query rows, ``2**gp_log`` groups in all), as many a SM as
    shared memory, 128 registers a thread and a cap of 8 allow, in whole
    clusters of 4 that share one load of the hubs, walk them; ``ri`` query
    rows a thread.  ``tiled``: 64 × 64 output tiles."""
    if not (0 < H <= _MAX_H and H % 4 == 0 and 0 < d <= _MAX_D
            and d % 4 == 0 and aligned):
        return {"path": "tiled", "tb": _TILE,
                "grid": _cdiv(B, _TILE) * _cdiv(H, _TILE), "smem": 0,
                "gp_log": 0, "ri": 0, "threads": 256}
    tb = 64
    while tb > 16 and _cdiv(B, tb) < 2 * n_sm:
        tb //= 2
    gp_log = 0
    while (1 << gp_log) < H // 4:
        gp_log += 1
    gw_log = min(gp_log, 2)              # hub groups across a warp's lanes
    hsplit = 1 << (gp_log - gw_log)      # warps side by side over the hubs
    threads = max(128, 32 * hsplit)
    rows_per_pass = threads // 32 // hsplit * (32 >> gw_log)
    stride = d + 4 if d % 8 == 0 else d
    smem = _HEAD + (4 * (1 << gp_log) + 2 * tb) * stride * 4
    per_sm = min(_SMEM_PER_SM // (smem + 1024), 65536 // (threads * 128), 8)
    blocks = min(_cdiv(B, tb), per_sm * n_sm)
    return {"path": "resident", "tb": tb,
            "grid": _cdiv(blocks, _CLUSTER) * _CLUSTER, "smem": smem,
            "gp_log": gp_log, "ri": max(1, tb // rows_per_pass),
            "threads": threads}


def _lib():
    return _build.load("twotower_score", _FUNCTIONS)


def cuda_plan(q, h) -> dict:
    """The plan the built source computes for these CUDA tensors (to hold
    ``plan`` against it on the card)."""
    out = (_I * len(_PLAN_KEYS))()
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.twotower_score_plan(_build.ptr(q), _build.ptr(h), q.shape[0],
                                      h.shape[0], q.shape[1], out)
    _build.check(lib, err, "twotower_score_plan")
    rec = dict(zip(_PLAN_KEYS, out))
    rec["path"] = _PATHS[rec["path"]]
    return rec


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
    if _cdiv(H, _TILE) > _MAX_GRID_Y:
        raise ValueError(f"twotower_score: H={H} exceeds the tiled grid's "
                         f"{_MAX_GRID_Y:,} hub tiles")
    out = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if B * H == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.twotower_score_f32(
            _build.ptr(q), _build.ptr(h), _build.ptr(out), B, H, d,
            _build.stream_of(q),
        )
    _build.check(lib, err, "twotower_score")
    twotower_score.launches += 1
    return out


twotower_score.launches = 0
