"""driver_self_ms: per converged step, the self time of the program's
``run`` span (``Simulator_M.run()`` less the ``chunk``, ``step``,
``commit``, ``save`` and ``checkpoint`` spans inside it) over the window's
run records: the time the driver itself takes, with no sync added."""
from program_runs import span, steps, window_runs


def read(run):
    recs = window_runs(run)
    n = recs and steps(recs)
    return 1e-6 * span(recs, "run", "self_ns")[1] / n if n else None
