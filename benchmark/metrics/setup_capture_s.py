"""setup_capture_s: the seconds of every ``capture`` span of the process
(a graph's warm-up call and capture) before the first window episode's
run, from that run record's process-wide totals: the part of set-up the
captured graphs take."""
from program_runs import window_runs


def read(run):
    recs = window_runs(run)
    if not recs:
        return None
    got = recs[0]["setup"]["spans"]["capture"]
    return 1e-9 * got["total_ns"] if got["count"] else None
