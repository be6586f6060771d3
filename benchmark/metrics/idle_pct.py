"""idle_pct: the share of an episode in which no operation ran on the
device: 1 - the device's busy seconds in the traced episode (the union of
torch.profiler's device intervals) over the host-clock length of the same
episode run without the profiler just before it.  The traced episode's
own length is not used: the profiler makes the host's side of it longer
(PERF.md, section 3)."""


def read(run):
    prof = run["trace"].get("profile")
    if not prof or not prof["kernels"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["plain_s"])
