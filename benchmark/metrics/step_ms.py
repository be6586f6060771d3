"""step_ms: the window's episode times summed, over the converged time
steps they hold (host clock; all the work over all the time)."""


def read(run):
    eps = run["episodes"]
    steps = sum(e["steps"] for e in eps)
    return 1e3 * sum(e["seconds"] for e in eps) / steps if steps else None
