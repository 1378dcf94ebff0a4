"""Beam-search hop kernels: batched in-kernel gather + masked distance.

Replace ``repro.kernels.gather_dist.gather_rows_dist`` and
``gather_rows_dist_q8`` (Pallas, one query per call, ids as scalar
prefetch).  Here one call serves the whole batch: ids (B, R), R the
index's padded degree, most slots -1.  The legacy ``gather_dist`` takes rows
the caller already gathered, (B, R, d).  The CUDA source is
``csrc/gather_dist.cu``; its header says what bounds the kernels on an H100
(device-memory bytes) and what the design does about it: one coalesced pass
over a query's ids that writes the invalid slots and compacts the valid
ones, then the valid rows by bulk async copy into shared memory (rows of a
multiple of 16 bytes on 16-byte aligned bases), or through registers for
any other width.  ``gather_dist`` takes the same front and ring with the
slot as the row, and sums ``‖q‖²`` once a query.

On CPU tensors, or with ``interpret=True``, the wrappers run the plain
versions in ``kernels.ref``; on CUDA tensors they launch the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LAUNCH = {
    "gather_rows_dist_f32": [_P, _P, _P, _P, _P, _I, _I, _L, _I, _P],
    "gather_rows_dist_q8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P],
    "gather_dist_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
}
# the query row is staged in shared memory beside the hop kernels' 5,168-byte
# head of barriers, (slot, id) pairs and per-row scalars: at most 227 KB a
# block
_MAX_WIDTH = (232448 - 5168) // 4


def ring_rows(row_bytes: int) -> int:
    """The bulk path's ring row slots for rows of ``row_bytes`` (4·d for K1,
    the padded code width for K2), read from the built kernel library
    (``gather_dist_ring_rows``): ~16 KB of rows, even, between 2 and 32."""
    f = _lib().gather_dist_ring_rows
    f.argtypes, f.restype = [_L], _I
    return f(row_bytes)


def _lib():
    return _build.load("gather_dist", _LAUNCH)


def _expect(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check(where, ids, tensors, inv_norms, n_rows):
    _expect(ids.dim() == 2 and ids.dtype == torch.int32,
            f"{where}: ids must be (B, R) int32, got {tuple(ids.shape)} {ids.dtype}")
    for name, t in tensors.items():
        _expect(t.device == ids.device,
                f"{where}: {name} is on {t.device}, ids on {ids.device}")
        _expect(t.is_contiguous(), f"{where}: {name} must be contiguous")
    if inv_norms is not None:
        _expect(inv_norms.shape == (n_rows,) and inv_norms.dtype == torch.float32,
                f"{where}: inv_norms must be ({n_rows},) float32")
        _expect(inv_norms.device == ids.device and inv_norms.is_contiguous(),
                f"{where}: inv_norms must be contiguous on {ids.device}")
    _expect(ids.is_contiguous(), f"{where}: ids must be contiguous")
    _expect(ids.device.type in ("cpu", "cuda"),
            f"{where}: unsupported device {ids.device}")


def gather_rows_dist(ids, db, q, inv_norms=None, *, interpret: bool = False):
    """(B, R) masked distances of the rows ``db[ids]`` to the rows of ``q``.

    ids (B, R) int32 (``-1`` = invalid → 3.4e38), db (N, d) float32,
    q (B, d) float32 (pre-normalized under cosine), inv_norms (N,) float32
    ``1/‖row‖`` — its presence selects cosine ``1 − inv[v]·Σ(v·q̂)``,
    its absence squared L2 ``Σ(v − q)²``.
    """
    _check("gather_rows_dist", ids, {"db": db, "q": q}, inv_norms, db.shape[0])
    B, R = ids.shape
    N, d = db.shape
    _expect(db.dtype == torch.float32 and q.dtype == torch.float32,
            "gather_rows_dist: db and q must be float32")
    _expect(q.shape == (B, d), f"gather_rows_dist: q must be ({B}, {d})")
    if interpret or ids.device.type == "cpu":
        return ref.gather_rows_dist_ref(ids, db, q, inv_norms)
    _expect(d <= _MAX_WIDTH, f"gather_rows_dist: d={d} > {_MAX_WIDTH}")
    out = torch.empty((B, R), dtype=torch.float32, device=ids.device)
    if B * R == 0:
        return out
    lib = _lib()
    with torch.cuda.device(ids.device):
        err = lib.gather_rows_dist_f32(
            _build.ptr(ids), _build.ptr(db), _build.ptr(q),
            _build.ptr(inv_norms), _build.ptr(out), B, R, N, d,
            _build.stream_of(ids),
        )
    _build.check(lib, err, "gather_rows_dist")
    gather_rows_dist.launches += 1
    return out


def gather_rows_dist_q8(ids, codes, scale, zero, q, inv_norms=None, *,
                        interpret: bool = False):
    """(B, R) masked *approximate* distances from int8 rows, dequantized
    ``c·scale + zero`` in registers with one (scale, zero) per row per
    block.  codes (N, Dp) int8, scale/zero (N, nb) float32, q (B, Dp)
    float32 zero-padded to the code width, inv_norms (N,) from the codebook
    (presence selects cosine).  Pad dims dequantize to exactly 0.0."""
    _check("gather_rows_dist_q8", ids,
           {"codes": codes, "scale": scale, "zero": zero, "q": q},
           inv_norms, codes.shape[0])
    B, R = ids.shape
    N, dp = codes.shape
    nb = scale.shape[1]
    _expect(codes.dtype == torch.int8, "gather_rows_dist_q8: codes must be int8")
    _expect(scale.dtype == zero.dtype == q.dtype == torch.float32,
            "gather_rows_dist_q8: scale, zero and q must be float32")
    _expect(scale.shape == zero.shape == (N, nb) and nb >= 1 and dp % nb == 0,
            f"gather_rows_dist_q8: scale/zero must be ({N}, nb) with nb | {dp}")
    _expect(q.shape == (B, dp), f"gather_rows_dist_q8: q must be ({B}, {dp})")
    if interpret or ids.device.type == "cpu":
        return ref.gather_rows_dist_q8_ref(ids, codes, scale, zero, q, inv_norms)
    _expect((dp // nb) % 4 == 0 and codes.data_ptr() % 4 == 0,
            "gather_rows_dist_q8: the kernel reads char4: block % 4 == 0")
    _expect(dp <= _MAX_WIDTH, f"gather_rows_dist_q8: Dp={dp} > {_MAX_WIDTH}")
    out = torch.empty((B, R), dtype=torch.float32, device=ids.device)
    if B * R == 0:
        return out
    lib = _lib()
    with torch.cuda.device(ids.device):
        err = lib.gather_rows_dist_q8(
            _build.ptr(ids), _build.ptr(codes), _build.ptr(scale),
            _build.ptr(zero), _build.ptr(q), _build.ptr(inv_norms),
            _build.ptr(out), B, R, N, dp, nb, _build.stream_of(ids),
        )
    _build.check(lib, err, "gather_rows_dist_q8")
    gather_rows_dist_q8.launches += 1
    return out


def gather_dist(vecs, q, ids, *, interpret: bool = False):
    """(B, R) masked squared L2 of pre-gathered rows: vecs (B, R, d), q
    (B, d), ids (B, R) int32 (``id < 0`` → exactly 3.4e38, the row is not
    read).  The kernel computes the dot form ``max(‖v‖² − 2v·q + ‖q‖², 0)``
    as the TPU kernel does; the plain version the difference form."""
    _expect(vecs.dim() == 3 and q.dim() == 2 and ids.dim() == 2,
            "gather_dist: need vecs (B, R, d), q (B, d), ids (B, R)")
    B, R, d = vecs.shape
    _expect(q.shape == (B, d) and ids.shape == (B, R),
            f"gather_dist: q must be ({B}, {d}) and ids ({B}, {R})")
    _expect(ids.dtype == torch.int32, "gather_dist: ids must be int32")
    _expect(vecs.device == q.device == ids.device
            and ids.device.type in ("cpu", "cuda"),
            "gather_dist: vecs, q and ids must be on one CPU or CUDA device")
    if interpret or ids.device.type == "cpu":
        return ref.gather_dist_ref(vecs, q, ids)
    _expect(d <= _MAX_WIDTH, f"gather_dist: d={d} > {_MAX_WIDTH}")
    vecs = vecs.to(torch.float32).contiguous()
    q = q.to(torch.float32).contiguous()
    ids = ids.contiguous()
    out = torch.empty((B, R), dtype=torch.float32, device=ids.device)
    if B * R == 0:
        return out
    lib = _lib()
    with torch.cuda.device(ids.device):
        err = lib.gather_dist_f32(
            _build.ptr(vecs), _build.ptr(q), _build.ptr(ids), _build.ptr(out),
            B, R, d, _build.stream_of(ids),
        )
    _build.check(lib, err, "gather_dist")
    gather_dist.launches += 1
    return out


gather_rows_dist.launches = 0
gather_rows_dist_q8.launches = 0
gather_dist.launches = 0
