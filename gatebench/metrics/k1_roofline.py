"""k1_roofline: K1 (``gather_rows_dist``, ``csrc/gather_dist.cu``) against
its roofline: the frozen ``hop_bound`` summed over every call the window
made, over K1's device time in the window's trace (the kernels named
below).  The calls' ids come from a replay of the window's batches after
the trace closed (``REPLAY``), so recording them costs the window
nothing."""
MOVES = "qps"
REPLAY = ("gather_rows_dist",)
KERNELS = ("rows_f32_bulk", "rows_f32_regs")


def read(run):
    bound_ms = run.bounds_ms.get(REPLAY[0])
    if run.trace is None or not bound_ms:
        return None
    t = run.trace.kernel_s(KERNELS)
    return 100.0 * bound_ms * 1e-3 / t if t > 0 else None
