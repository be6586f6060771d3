"""fp_it_per_step: fixed-point iterations per converged step, from the
statistics the step calls return (the f32 sweep's iterations included)."""


def read(run):
    eps = run["episodes"]
    steps = sum(e["steps"] for e in eps)
    return sum(e["fp"] for e in eps) / steps if steps else None
