"""save_span_ms: the mean length of the program's ``save`` spans (kept
saves of the outputs, the derived fields and the wait for the device
included) and ``checkpoint`` spans in the window's run records."""
from program_runs import span, window_runs


def read(run):
    recs = window_runs(run)
    if not recs:
        return None
    n_save, ns_save = span(recs, "save")
    n_ckpt, ns_ckpt = span(recs, "checkpoint")
    n = n_save + n_ckpt
    return 1e-6 * (ns_save + ns_ckpt) / n if n else None
