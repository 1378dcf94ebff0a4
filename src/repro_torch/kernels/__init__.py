"""The port's kernels: hand-written CUDA for Hopper plus plain versions.

  gather_rows_dist     batched in-kernel gather + fp32 distance (K1)
  gather_rows_dist_q8  the same from the int8 codebook (K2)
  twotower_score       fused normalize + cosine scores (K3)
  topk_min             k smallest per row, ties to the lowest index (K4)
  l2dist               tiled squared-L2 distance matrix (K5)
  gather_dist          masked L2 of pre-gathered rows, the legacy kernel (K6)
  greedy_assign        sequential greedy balanced assignment (greedy HBKM;
                       port-only, ``repro`` scans it in JAX)

Each wrapper runs its plain PyTorch version (``kernels.ref``) on CPU tensors
and launches its CUDA kernel on CUDA tensors; it counts its launches, so a
run can show that a path went through the kernel.  ``kernels.ops`` is the
public API with a ``mode`` per call.

The names ``gather_dist``, ``l2dist`` and ``topk_min`` here are the ``ops``
*functions*, which shadow the submodules of the same names: import a
submodule by its full path (``repro_torch.kernels.gather_dist``).
"""
from repro_torch.kernels.gather_dist import gather_dist as _gather_dist
from repro_torch.kernels.gather_dist import gather_rows_dist, gather_rows_dist_q8
from repro_torch.kernels.greedy_assign import greedy_assign
from repro_torch.kernels.l2dist import l2dist as _l2dist
from repro_torch.kernels.topk import topk_min as _topk_min
from repro_torch.kernels.twotower_score import twotower_score as _twotower_score
from repro_torch.kernels.ops import gather_dist, l2dist, topk_min, twotower_score

# the wrappers that launch each kernel and count the launches
KERNELS = {
    "gather_rows_dist": gather_rows_dist,
    "gather_rows_dist_q8": gather_rows_dist_q8,
    "twotower_score": _twotower_score,
    "topk_min": _topk_min,
    "l2dist": _l2dist,
    "gather_dist": _gather_dist,
    "greedy_assign": greedy_assign,
}


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS", "gather_dist", "gather_rows_dist", "gather_rows_dist_q8",
    "greedy_assign", "l2dist", "launch_counts", "reset_launch_counts", "topk_min",
    "twotower_score",
]
