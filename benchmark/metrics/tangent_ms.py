"""tangent_ms: device time per tangent build, from CUDA events recorded
around each call of the equation's tangent suite (a copy of chip_smoke.py's
StepClock)."""


def read(run):
    ms = run["trace"]["tangent_ms"]
    return sum(ms) / len(ms) if ms else None
