"""qps: the queries of every batch the window completed, over the window's
seconds (host clock; the window ends when its last batch's answers are in)."""
MOVES = None   # an end-to-end metric


def read(run):
    return sum(len(a.result["ids"]) for a in run.window.answers) / run.window.seconds
