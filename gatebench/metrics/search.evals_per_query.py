"""search.evals_per_query: the mean of ``SearchResult.dist_evals``, the
search's own count of distances computed, over every query the window
answered."""
MOVES = "qps"


def read(run):
    n = sum(len(a.result["evals"]) for a in run.window.answers)
    return sum(float(a.result["evals"].sum()) for a in run.window.answers) / n if n else None
