"""search.lockstep_pct: 100 × Σ hops ÷ (queries × loop iterations), over
the window's batches.  The lockstep loop runs until its longest query
stops, so a batch's iterations are its largest ``hops``; this is the share
of the loop's query-iterations that expanded a node."""
MOVES = "qps"


def read(run):
    work = slots = 0
    for a in run.window.answers:
        h = a.result["hops"]
        work += int(h.sum())
        slots += len(h) * int(h.max())
    return 100.0 * work / slots if slots else None
