"""precond_applies_per_step: applies of the dense preconditioner per
converged step, from the ``precond_launches`` counter deltas of the
window's run records (one launch of its kernel per apply): about two per
BiCGStab iteration, plus one at the start of each solve.  A program whose
counters lack it gives nothing."""
from program_runs import steps, window_runs


def read(run):
    recs = window_runs(run)
    if not recs or any("precond_launches" not in r["counters"]
                       for r in recs):
        return None
    n = steps(recs)
    return sum(r["counters"]["precond_launches"] for r in recs) / n \
        if n else None
