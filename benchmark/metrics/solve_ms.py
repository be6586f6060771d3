"""solve_ms: device time per linear solve (the f64 solve and the f32
sweep's), from CUDA events around each call (StepClock)."""


def read(run):
    ms = run["trace"]["solve_ms"]
    return sum(ms) / len(ms) if ms else None
