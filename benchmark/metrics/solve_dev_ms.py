"""solve_dev_ms: the mean device time of the program's ``solve`` spans
(CUDA event pairs around each linear solve, the f64 solve's and the float32
sweep's) in the window's run records: ms per solve.  Only on CUDA."""
from program_runs import window_runs


def read(run):
    recs = window_runs(run)
    ms = [m for r in recs or () for _, m in r["device"]["solve"]]
    return sum(ms) / len(ms) if ms else None
