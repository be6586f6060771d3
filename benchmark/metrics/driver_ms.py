"""driver_ms: per converged step, the traced episodes' time outside the
equations' step calls (``solve_time_steps``, ``solve_tm_time_steps``,
``solve_time_step``, ``commit_time_step`` and the heat equation's
``solve``, each outermost call ended by a sync),
the kept saves and the checkpoints: the time the simulator itself takes
(host clock)."""


def read(run):
    eps = run["episodes"]
    steps = sum(e["steps"] for e in eps)
    rest = sum(e["seconds"] - e["solve_s"] - sum(e["save_s"]) for e in eps)
    return 1e3 * rest / steps if steps else None
