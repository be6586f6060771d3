"""Post-process the two-region cube run: per-region stress paths.

The port's twin of examples/mechanics/2_cube_regions/plot_results.py: the same figure from
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
    out_root = out_root or os.path.join(here, "output", "case_0")

    t, p, pts, topo = pp.read_timeseries(out_root, "p_elems")
    _, q, _, _ = pp.read_timeseries(out_root, "q_elems")
    cc = pp.compute_cell_centroids(topo, pts)
    zmid = 0.5 * (cc[:, 2].min() + cc[:, 2].max())
    lower, upper = cc[:, 2] < zmid, cc[:, 2] >= zmid

    _, u, upts, _ = pp.read_timeseries(out_root, "u")
    top = upts[:, 2].argmax()

    fig, axes = plt.subplots(1, 2, figsize=(9, 3.6))
    for sel, label in ((lower, "lower region"), (upper, "upper region")):
        axes[0].plot(p[:, sel].mean(axis=1) / MPa, q[:, sel].mean(axis=1)
                     / MPa, "-o", ms=3, label=label)
    axes[0].set_xlabel("mean stress p (MPa)")
    axes[0].set_ylabel("von Mises q (MPa)")
    axes[0].legend(fontsize=8)
    axes[1].plot(np.asarray(t) / hour, u[:, top, 2] * 1e3, "-o", ms=3)
    axes[1].set_xlabel("time (h)")
    axes[1].set_ylabel("top displacement u_z (mm)")
    for ax in axes:
        ax.grid(True, alpha=0.4)
    fig.tight_layout()
    png = os.path.join(out_root, "results.png")
    fig.savefig(png, dpi=130)
    print(f"wrote {png}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
