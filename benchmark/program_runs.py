"""The program's own run records of a benchmark run's window.

``safeincave_torch.tracing`` keeps one record per ``Simulator_M.run()``
(spans, gaps, counter deltas, device spans, and the process-wide totals at
the run's start).  The window's records are those whose [start, end] holds
a save stamp of a window episode, one per episode; the warm stages, the
episode before the window and the profiled episodes after it hold none of
the window's stamps.  A program without the tracer gives nothing.
"""


def window_runs(run):
    """The run records of the window's episodes, in order, or None unless
    each episode has exactly one, and no two share one."""
    try:
        from safeincave_torch import tracing
    except ImportError:
        return None
    records = list(getattr(tracing, "runs", ()))
    out = []
    for ep in run["episodes"]:
        stamps = [round(s * 1e9) for s in ep.get("stamps", ())]
        hits = [r for r in records
                if any(r["start_ns"] <= s <= r["end_ns"] for s in stamps)]
        if len(hits) != 1:
            return None
        out.append(hits[0])
    if not out or len({id(r) for r in out}) != len(out):
        return None
    return out


def span(records, name, key="total_ns"):
    """(count, ``key`` ns) of span ``name`` summed over ``records``."""
    got = [r["spans"].get(name, {}) for r in records]
    return (sum(s.get("count", 0) for s in got),
            sum(s.get(key, 0) for s in got))


def steps(records):
    return sum(r["steps"] for r in records)
