"""The port's kernels: hand-written CUDA for Hopper plus plain versions.

  gather_rows_dist     batched in-kernel gather + fp32 distance (K1)
  gather_rows_dist_q8  the same from the int8 codebook (K2)
  twotower_score       fused normalize + cosine scores (K3)

Each wrapper runs its plain PyTorch version (``kernels.ref``) on CPU tensors
and launches its CUDA kernel on CUDA tensors; it counts its launches, so a
run can show that the main path went through the kernel.
"""
from repro_torch.kernels.gather_dist import gather_rows_dist, gather_rows_dist_q8
from repro_torch.kernels.twotower_score import twotower_score

KERNELS = {
    "gather_rows_dist": gather_rows_dist,
    "gather_rows_dist_q8": gather_rows_dist_q8,
    "twotower_score": twotower_score,
}


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS", "gather_rows_dist", "gather_rows_dist_q8", "launch_counts",
    "reset_launch_counts", "twotower_score",
]
