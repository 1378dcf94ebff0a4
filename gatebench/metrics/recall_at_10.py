"""recall_at_10: recall@10 of every answer the window gave, against exact
ground truth that the benchmark's reference computes (float64 brute
force)."""
from gatebench import check

MOVES = None   # an end-to-end metric


def read(run):
    return check.recall(run.db, run.pool, run.window.answers, 10, run.device)
