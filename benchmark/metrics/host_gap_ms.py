"""host_gap_ms: per converged step, the time the device had nothing
queued while the host ran the program's code: from each read's return (and
the run's start) to the next graph replay, hand-kernel launch or read,
summed over every cause in the window's run records.  Only on CUDA."""
from program_runs import steps, window_runs


def read(run):
    recs = window_runs(run)
    if not recs or not all(r["cuda"] for r in recs):
        return None
    n = steps(recs)
    gap = sum(sum(r["gaps"].values()) for r in recs)
    return 1e-6 * gap / n if n else None
