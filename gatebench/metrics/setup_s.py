"""setup_s: from the harness's first line to the window's start (host
clock): the kernels from the cache, the data and queries from the seed,
the index build and the warm-up at the cell's own shapes."""
MOVES = None   # an end-to-end metric


def read(run):
    return run.setup_s
