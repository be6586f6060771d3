"""heat_ms: device time per heat step, from CUDA events recorded around
each ``HeatDiffusion.step`` of the traced window (``StepClock``): the
heat equation's assembly of its right-hand side and its CG solve, run
eagerly outside the captured graphs.  Nothing in a cell without heat or
off the card."""


def read(run):
    ms = run["trace"]["heat_ms"]
    return sum(ms) / len(ms) if ms else None
