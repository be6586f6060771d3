"""reads_per_step: the program's own count of host reads of tensors (its
``read`` spans) per converged step of the window's run records: a count,
never a time."""
from program_runs import span, steps, window_runs


def read(run):
    recs = window_runs(run)
    n = recs and steps(recs)
    return span(recs, "read")[0] / n if n else None
