"""Sequential greedy balanced assignment (greedy HBKM's inner pass).

A port-only kernel: ``repro`` runs this pass as a ``lax.scan`` over rows
(``repro.core.hbkm._assign_greedy``) and has no Pallas kernel for it.  Row
i picks ``argmin_j d2[i, j] + lam·((2·count_j − 2·target) + 1)`` against
the counts of the rows before it, so the pass is a chain of n dependent
argmins: a loop of PyTorch ops a row would take minutes at 1M rows.  The
CUDA source is ``csrc/greedy_assign.cu`` (one warp walks the rows); on CPU
tensors the wrapper runs the plain version in ``kernels.ref``.  Both give
the same bits.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FUNCTIONS = {"greedy_assign_f32": [_P, _I, _I, _F, _F, _P, _P]}
MAX_K = 32


def _lib():
    return _build.load("greedy_assign", _FUNCTIONS)


def greedy_assign(d2, lam_eff: float, target: float):
    """(n, k) squared distances → (n,) int32 greedy assignment (the kernel
    takes k ≤ 32; the plain version any k).

    ``lam_eff`` and ``target`` are float32 values (``repro`` computes both
    in float32); the penalty is rounded term by term as ``repro`` does."""
    if d2.dim() != 2 or d2.dtype != torch.float32:
        raise ValueError(f"greedy_assign: need (n, k) float32, got "
                         f"{tuple(d2.shape)} {d2.dtype}")
    n, k = d2.shape
    if d2.device.type == "cpu":
        return ref.greedy_assign_ref(d2, lam_eff, target)
    if d2.device.type != "cuda":
        raise ValueError(f"greedy_assign: d2 on {d2.device}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"greedy_assign: the kernel takes k in 1..{MAX_K}, "
                         f"got {k}")
    d2 = d2.contiguous()
    out = torch.empty((n,), dtype=torch.int32, device=d2.device)
    if n == 0:
        return out
    two_t = float(np.float32(2.0) * np.float32(target))
    lib = _lib()
    with torch.cuda.device(d2.device):
        err = lib.greedy_assign_f32(
            _build.ptr(d2), n, k, float(np.float32(lam_eff)), two_t,
            _build.ptr(out), _build.stream_of(d2),
        )
    _build.check(lib, err, "greedy_assign")
    greedy_assign.launches += 1
    return out


greedy_assign.launches = 0
