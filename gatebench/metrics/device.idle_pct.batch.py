"""device.idle_pct.batch: 100 × (1 − device busy ÷ window) over the traced
window of a batch cell; busy is the union of the device's kernels, copies
and fills in the profiler's raw events."""
MOVES = "qps"


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
