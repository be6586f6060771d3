"""setup_precond_s: the seconds of every ``precond`` span of the process
(preconditioner builds, each ended by a synchronize) before the first
window episode's run, from that run record's process-wide totals: the part
of set-up the preconditioner takes."""
from program_runs import window_runs


def read(run):
    recs = window_runs(run)
    if not recs:
        return None
    got = recs[0]["setup"]["spans"]["precond"]
    return 1e-9 * got["total_ns"] if got["count"] else None
