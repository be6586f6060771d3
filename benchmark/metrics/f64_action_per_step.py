"""f64_action_per_step: launches of the band kernel's f64 action per
converged step, from the ``band64_launches`` counter deltas of the window's
run records (one launch per defect-correction residual, initial residual or
lifting matvec that runs on it): about one per two Krylov iterations, plus
two at the start of each solve.  A program whose counters lack it gives
nothing."""
from program_runs import steps, window_runs


def read(run):
    recs = window_runs(run)
    if not recs or any("band64_launches" not in r["counters"]
                       for r in recs):
        return None
    n = steps(recs)
    return sum(r["counters"]["band64_launches"] for r in recs) / n \
        if n else None
