"""k2_roofline: K2 (``gather_rows_dist_q8``, ``csrc/gather_dist.cu``, the
int8 codebook's hop kernel) against its roofline, read as
``k1_roofline`` is: the frozen ``hop_bound`` (a row is its codes and its
blocks' scales and zeros) summed over the window's calls, over K2's device
time."""
MOVES = "qps"
REPLAY = ("gather_rows_dist_q8",)
KERNELS = ("rows_q8_bulk", "rows_q8_regs")


def read(run):
    bound_ms = run.bounds_ms.get(REPLAY[0])
    if run.trace is None or not bound_ms:
        return None
    t = run.trace.kernel_s(KERNELS)
    return 100.0 * bound_ms * 1e-3 / t if t > 0 else None
