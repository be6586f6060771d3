"""Post-process the thermal cube run: T profiles along the heated axis.

The port's twin of examples/thermal/1_cube/plot_results.py: the same figure from
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
from safeincave_torch.utils import hour  # noqa: E402


def main(out_root=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    here = os.path.dirname(os.path.abspath(__file__))
    out_root = out_root or os.path.join(here, "output", "thermal_cube")

    t, T, pts, _ = pp.read_timeseries(out_root, "T")
    t = np.asarray(t)
    T = T.reshape(T.shape[0], -1)

    # nodes on the vertical line through the x/y midpoint (same line-
    # extraction idiom as the reference's (y,z) line selection)
    xm = np.median(np.unique(pts[:, 0]))
    ym = np.median(np.unique(pts[:, 1]))
    line = np.where((np.abs(pts[:, 0] - xm) < 1e-12)
                    & (np.abs(pts[:, 1] - ym) < 1e-12))[0]
    order = np.argsort(pts[line, 2])
    line = line[order]
    z = pts[line, 2]

    fig, axes = plt.subplots(1, 2, figsize=(9, 3.6))
    n_snap = min(5, len(t))
    snap_idx = np.unique(np.linspace(0, len(t) - 1, n_snap).astype(int))
    for k in snap_idx:
        axes[0].plot(T[k, line], z, "-o", ms=3,
                     label=f"t = {t[k]/hour:.1f} h")
    axes[0].set_xlabel("temperature (K)")
    axes[0].set_ylabel("z (m)")
    axes[0].legend(fontsize=8)

    for j, name in ((0, "bottom"), (len(line) // 2, "middle"),
                    (len(line) - 1, "top")):
        axes[1].plot(t / hour, T[:, line[j]], "-o", ms=3, label=name)
    axes[1].set_xlabel("time (h)")
    axes[1].set_ylabel("temperature (K)")
    axes[1].legend(fontsize=8)
    for ax in axes:
        ax.grid(True, alpha=0.4)
    fig.tight_layout()
    png = os.path.join(out_root, "results.png")
    fig.savefig(png, dpi=130)
    print(f"wrote {png}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
