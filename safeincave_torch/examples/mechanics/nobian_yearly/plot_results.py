"""Post-process the yearly production run.

The port's twin of examples/mechanics/nobian_yearly/plot_results.py: the same figure from
the outputs read back through safeincave_torch.postproc (no h5py);
matplotlib is imported when the figure is drawn.

Run after main.py:  python plot_results.py [output_dir]

"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

from safeincave_torch import postproc as pp  # noqa: E402
from safeincave_torch import schedules  # noqa: E402
from safeincave_torch.utils import MPa, day  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def main(out_root=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_root = out_root or os.path.join(HERE, "output", "nobian_yearly")
    op = os.path.join(out_root, "operation")

    t_u, u, upts, _ = pp.read_timeseries(op, "u")
    t_q, q, _, _ = pp.read_timeseries(op, "q_elems")
    t_u = np.asarray(t_u)
    t_q = np.asarray(t_q)

    p_mpa = schedules.read_pressure_csv(
        os.path.join(HERE, "..", "..", "..", "..", "examples", "mechanics",
                     "nobian_yearly", "data", "operational_year.csv"))

    fig, axes = plt.subplots(2, 2, figsize=(11, 6.5))
    ax = axes[0, 0]
    ax.plot(np.arange(p_mpa.size) / 24.0, p_mpa, lw=0.6)
    ax.set_ylabel("cavern pressure (MPa)")
    ax.set_xlabel("time (day)")
    ax.set_title("operational year (CSV)", fontsize=9)

    # cavern-wall convergence: displacement magnitude of the node that
    # moves the most (on the wall by construction)
    umag = np.linalg.norm(u, axis=2)
    wall = umag[-1].argmax()
    ax = axes[0, 1]
    ax.plot(t_u / day, umag[:, wall] * 1e3, "-o", ms=2.5)
    ax.set_ylabel("max |u| (mm)")
    ax.set_xlabel("time (day)")
    ax.set_title("cavern-wall closure", fontsize=9)

    ax = axes[1, 0]
    ax.plot(t_q / day, q.mean(axis=1) / MPa, "-o", ms=2.5, label="mean")
    ax.plot(t_q / day, q.max(axis=1) / MPa, "-o", ms=2.5, label="max")
    ax.set_ylabel("von Mises (MPa)")
    ax.set_xlabel("time (day)")
    ax.legend(fontsize=8)

    ax = axes[1, 1]
    mpath = os.path.join(out_root, "metrics.jsonl")
    if os.path.isfile(mpath):
        rows = [json.loads(ln) for ln in open(mpath) if ln.strip()]
        ts = np.asarray([r["t"] for r in rows]) / day
        ax.plot(ts, [r["fp_iters"] for r in rows], ".", ms=3,
                label="fp iters")
        ax2 = ax.twinx()
        ax2.plot(ts, [r.get("krylov_total", 0) for r in rows], ".", ms=3,
                 color="tab:orange", label="krylov")
        ax2.set_ylabel("krylov iters/step", color="tab:orange")
        ax.set_ylabel("fp iters/step")
        ax.set_xlabel("time (day)")
        ax.set_title("solver health (metrics.jsonl)", fontsize=9)
    for a in axes.ravel():
        a.grid(True, alpha=0.4)
    fig.tight_layout()
    png = os.path.join(out_root, "results.png")
    fig.savefig(png, dpi=130)
    print(f"wrote {png}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
