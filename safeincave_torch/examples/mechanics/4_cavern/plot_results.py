"""Post-process the cavern run: probe time-series from the XDMF outputs.

The port's twin of examples/mechanics/4_cavern/plot_results.py: the same figure from
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
from safeincave_torch.utils import MPa, hour  # noqa: E402


def main(out_root=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    here = os.path.dirname(os.path.abspath(__file__))
    out_root = out_root or os.path.join(here, "output")
    op = os.path.join(out_root, "operation")

    # displacement at the highest point of the mesh interior (cavern roof
    # region): largest |u_z| response to the pressure cycle
    t_u, u, pts, _ = pp.read_timeseries(op, "u")
    roof = pts[:, 2].argmax()
    t_q, q, cpts, topo = pp.read_timeseries(op, "q_elems")
    cc = pp.compute_cell_centroids(topo, pts)
    wall = np.linalg.norm(cc - cc.mean(axis=0), axis=1).argmin()

    fig, axes = plt.subplots(1, 2, figsize=(9, 3.6))
    axes[0].plot(np.asarray(t_u) / hour, u[:, roof, 2] * 1e3, "-o", ms=3)
    axes[0].set_xlabel("time (h)")
    axes[0].set_ylabel("roof settlement u_z (mm)")
    axes[1].plot(np.asarray(t_q) / hour, q[:, wall] / MPa, "-o", ms=3)
    axes[1].set_xlabel("time (h)")
    axes[1].set_ylabel("von Mises near cavern (MPa)")
    for ax in axes:
        ax.grid(True, alpha=0.4)
    fig.tight_layout()
    png = os.path.join(out_root, "results.png")
    fig.savefig(png, dpi=130)
    print(f"wrote {png}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
