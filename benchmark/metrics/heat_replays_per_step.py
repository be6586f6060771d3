"""heat_replays_per_step: replays of the heat equation's captured graphs
per converged step, from the ``heat_replays`` counter deltas of the
window's run records (``Simulator_TM.run()``): the step's set-up and the
blocks of its CG solve, a few per defect-correction pass.  A program whose
counters lack it gives nothing."""
from program_runs import steps, window_runs


def read(run):
    recs = window_runs(run)
    if not recs or any("heat_replays" not in r["counters"] for r in recs):
        return None
    n = steps(recs)
    return sum(r["counters"]["heat_replays"] for r in recs) / n \
        if n else None
