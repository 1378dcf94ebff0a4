"""Per-block int8 scalar quantization of the base vectors.

A numpy copy of ``repro.quant``, bit for bit: the same codes, scales, zeros
and inverse norms.  Scheme (affine, integer zero-point):

    per row i, per 128-dim block b:
      mn    = min(block min, 0),  mx = max(block max, 0)
      scale = max((mx - mn) / 254, eps)
      zp    = -127 - round(mn / scale)          # integer, in [-127, 127]
      code  = clip(round(x / scale) + zp, -127, 127)   int8
      x̂     = scale * code + zero,   zero = -scale * zp

Every block spans 0, so the zero-point needs no clamp and the pad code of a
row padded to whole blocks dequantizes to exactly 0.0: odd ``d`` needs no
masking in the kernels.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

BLOCK = 128
_EPS = 1e-12


class QuantizedDb(NamedTuple):
    """int8 codebook of an (N, d) database, per-(row, block) affine params.

    codes      (N, nb·block) int8 — rows padded to whole blocks
    scale      (N, nb) float32
    zero       (N, nb) float32    — ``-scale * zp``
    inv_norms  (N,) float32       — 1 / ‖dequantized row‖ (cosine path)
    """

    codes: Union[np.ndarray, torch.Tensor]
    scale: Union[np.ndarray, torch.Tensor]
    zero: Union[np.ndarray, torch.Tensor]
    inv_norms: Union[np.ndarray, torch.Tensor]

    @property
    def block(self) -> int:
        return self.codes.shape[1] // self.scale.shape[1]

    @property
    def n_blocks(self) -> int:
        return self.scale.shape[1]

    def to(self, device) -> "QuantizedDb":
        """The same codebook as tensors on ``device``."""
        return QuantizedDb(*(torch.as_tensor(a, device=device) for a in self))


def quantize_db(db: np.ndarray, block: int = BLOCK) -> QuantizedDb:
    """Host-side (numpy, deterministic) per-block int8 quantization."""
    x = np.asarray(db, np.float32)
    N, d = x.shape
    nb = max((d + block - 1) // block, 1)
    xp = np.zeros((N, nb * block), np.float32)
    xp[:, :d] = x
    blocks = xp.reshape(N, nb, block)
    mn = np.minimum(blocks.min(axis=2), 0.0)
    mx = np.maximum(blocks.max(axis=2), 0.0)
    scale = np.maximum((mx - mn) / 254.0, _EPS).astype(np.float32)
    zp = np.round(-127.0 - mn / scale).astype(np.float32)
    codes = np.clip(
        np.round(blocks / scale[:, :, None]) + zp[:, :, None], -127, 127
    ).astype(np.int8)
    zero = (-scale * zp).astype(np.float32)
    deq = codes.astype(np.float32) * scale[:, :, None] + zero[:, :, None]
    inv_norms = (
        1.0 / np.maximum(np.sqrt((deq.reshape(N, -1) ** 2).sum(axis=1)), 1e-9)
    ).astype(np.float32)
    return QuantizedDb(
        codes=codes.reshape(N, nb * block), scale=scale, zero=zero,
        inv_norms=inv_norms,
    )


def dequantize(qdb: QuantizedDb, d: int = None):
    """(N, d) float32 reconstruction (numpy in → numpy out, torch → torch)."""
    N = qdb.codes.shape[0]
    nb, blk = qdb.n_blocks, qdb.block
    if isinstance(qdb.codes, torch.Tensor):
        c = qdb.codes.reshape(N, nb, blk).to(torch.float32)
    else:
        c = qdb.codes.reshape(N, nb, blk).astype(np.float32)
    deq = (c * qdb.scale[:, :, None] + qdb.zero[:, :, None]).reshape(N, nb * blk)
    return deq if d is None else deq[:, :d]


def memory_bytes(qdb: QuantizedDb) -> int:
    """Resident bytes of the quantized codebook."""
    return int(sum(
        a.numel() * a.element_size() if isinstance(a, torch.Tensor)
        else np.asarray(a).nbytes
        for a in qdb
    ))


def quant_config(qdb: QuantizedDb) -> dict:
    """Schema fragment recorded into benchmark results and build reports."""
    return {
        "block": qdb.block,
        "n_blocks": qdb.n_blocks,
        "bytes": memory_bytes(qdb),
        "bytes_per_row": (
            qdb.codes.shape[1] + 8 * qdb.n_blocks + 4  # codes + scale/zero + inv_norm
        ),
    }
