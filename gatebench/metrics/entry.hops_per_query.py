"""entry.hops_per_query: the mean of ``SearchResult.hops``, the search's own
count of expansions, over every query the window answered.  GATE's choice
of entry shows as the length of the path from it."""
MOVES = "qps"


def read(run):
    n = sum(len(a.result["hops"]) for a in run.window.answers)
    return sum(float(a.result["hops"].sum()) for a in run.window.answers) / n if n else None
