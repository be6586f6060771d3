"""save_ms: the mean host-clock time of a kept save or a checkpoint, from
a sync to the end of the write (a copy of chip_smoke.py's timed_saves)."""


def read(run):
    secs = [s for e in run["episodes"] for s in e["save_s"]]
    return 1e3 * sum(secs) / len(secs) if secs else None
