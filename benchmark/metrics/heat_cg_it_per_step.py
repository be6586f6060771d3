"""heat_cg_it_per_step: heat CG iterations per converged step of the
window, from the rows that ``solve_tm_time_steps`` returns and from the
heat equation's ``solver_stats`` after each ``HeatDiffusion.solve`` the
driver makes itself (its per-step path): a count.  In the default
mixed precision it counts the float32 inner iterations of every defect
correction pass.  Nothing in a cell without heat."""


def read(run):
    eps = run["episodes"]
    if any(e["heat_cg"] is None for e in eps):
        return None
    steps = sum(e["steps"] for e in eps)
    return sum(e["heat_cg"] for e in eps) / steps if steps else None
