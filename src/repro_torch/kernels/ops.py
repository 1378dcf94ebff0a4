"""The kernel API: one function per kernel, each with a ``mode``.

    auto       the CUDA kernel for CUDA tensors, the plain PyTorch version
               for CPU tensors (the rule every wrapper follows)
    cuda       the CUDA kernel; CPU tensors raise
    interpret  the plain version in ``kernels.ref`` (as
               ``SearchParams.kernel_interpret``)
    ref        an alias of ``interpret``, kept for parity with ``repro``'s
               mode names: both take the wrapper's one plain route

No mode catches a build or launch failure: it raises to the caller.
"""
from __future__ import annotations

from repro_torch.kernels.gather_dist import gather_dist as _gather_dist
from repro_torch.kernels.l2dist import l2dist as _l2dist
from repro_torch.kernels.topk import topk_min as _topk_min
from repro_torch.kernels.twotower_score import twotower_score as _twotower_score

MODES = ("auto", "cuda", "interpret", "ref")


def _kernel_args(name: str, mode: str, tensor) -> dict:
    """The wrapper's ``interpret=`` for ``mode``; raises on a bad mode and
    on ``mode="cuda"`` with a tensor that is not on a CUDA device."""
    if mode not in MODES:
        raise ValueError(f"{name}: mode must be one of {MODES}, got {mode!r}")
    if mode == "cuda" and tensor.device.type != "cuda":
        raise ValueError(
            f'{name}(mode="cuda") needs CUDA tensors, got {tensor.device}')
    return {"interpret": mode in ("interpret", "ref")}


def l2dist(q, c, *, mode: str = "auto"):
    """(Q, d) × (C, d) → (Q, C) squared L2, fp32."""
    return _l2dist(q, c, **_kernel_args("l2dist", mode, q))


def topk_min(d, k: int, *, mode: str = "auto"):
    """(B, C) → (values (B, k) ascending, indices (B, k) int32); ties go to
    the lowest index."""
    return _topk_min(d, k, **_kernel_args("topk_min", mode, d))


def gather_dist(vecs, q, ids, *, mode: str = "auto"):
    """(B, R, d), (B, d), (B, R) → (B, R) masked squared L2 (3.4e38 where
    ``id < 0``)."""
    return _gather_dist(vecs, q, ids,
                        **_kernel_args("gather_dist", mode, ids))


def twotower_score(q, h, *, mode: str = "auto"):
    """(B, d) × (H, d) → (B, H) cosine similarity, fp32."""
    return _twotower_score(q, h,
                           **_kernel_args("twotower_score", mode, q))
