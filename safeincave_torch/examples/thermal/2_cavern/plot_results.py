"""Post-process the thermal cavern run: temperature front over time.

The port's twin of examples/thermal/2_cavern/plot_results.py: the same figure from
the outputs read back through safeincave_torch.postproc (no h5py);
matplotlib is imported when the figure is drawn.

Run after main.py:  python plot_results.py [output_dir]

"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

from safeincave_torch import postproc as pp  # noqa: E402
from safeincave_torch.utils import day  # noqa: E402


def main(out_root=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    here = os.path.dirname(os.path.abspath(__file__))
    out_root = out_root or os.path.join(here, "output", "case_0")

    t, T, pts, _ = pp.read_timeseries(out_root, "T")
    T = T.reshape(T.shape[0], -1)
    center = pts.mean(axis=0)
    r = np.linalg.norm(pts - center, axis=1)
    wall, far = r.argmin(), r.argmax()

    fig, axes = plt.subplots(1, 2, figsize=(9, 3.6))
    td = np.asarray(t) / day
    axes[0].plot(td, T[:, wall], "-o", ms=3, label="cavern wall")
    axes[0].plot(td, T[:, far], "-o", ms=3, label="far field")
    axes[0].set_xlabel("time (days)")
    axes[0].set_ylabel("temperature (K)")
    axes[0].legend(fontsize=8)
    order = np.argsort(r)
    axes[1].plot(r[order], T[-1, order], ".", ms=2)
    axes[1].set_xlabel("distance from cavern (m)")
    axes[1].set_ylabel(f"T at t={td[-1]:.1f} d (K)")
    for ax in axes:
        ax.grid(True, alpha=0.4)
    fig.tight_layout()
    png = os.path.join(out_root, "results.png")
    fig.savefig(png, dpi=130)
    print(f"wrote {png}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
