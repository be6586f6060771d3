"""mc_yield_pct: the share of the Mohr-Coulomb elements that can flow
(mu_1 > 0: the interlayers) whose yield function is positive at the
committed state, over the converged steps of the window: the
``mc_yield_elems`` counter deltas of the window's run records over their
``mc_elem_steps`` deltas (the elements that can flow, once per committed
step), in %.  The yielding elements drive the fixed-point and Krylov
counts of a cell with Mohr-Coulomb interlayers.  A program whose counters
lack them, or a cell without such elements, gives nothing."""
from program_runs import window_runs

KEYS = ("mc_yield_elems", "mc_elem_steps")


def read(run):
    recs = window_runs(run)
    if not recs or any(k not in r["counters"] for r in recs for k in KEYS):
        return None
    elems = sum(r["counters"]["mc_elem_steps"] for r in recs)
    if not elems or not sum(r["steps"] for r in recs):
        return None
    return 100.0 * sum(r["counters"]["mc_yield_elems"] for r in recs) / elems
