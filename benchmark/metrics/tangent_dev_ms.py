"""tangent_dev_ms: the mean device time of the program's ``tangent``
spans (CUDA event pairs around each replay of the tangent suite) in the
window's run records: ms per build.  Only on CUDA."""
from program_runs import window_runs


def read(run):
    recs = window_runs(run)
    ms = [m for r in recs or () for _, m in r["device"]["tangent"]]
    return sum(ms) / len(ms) if ms else None
