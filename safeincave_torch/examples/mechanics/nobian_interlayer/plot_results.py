"""Post-process the heterogeneous interlayer run: per-region response.

The port's twin of examples/mechanics/nobian_interlayer/plot_results.py: the same figure from
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

    t, q, pts, topo = pp.read_timeseries(out_root, "q_elems")
    cc = pp.compute_cell_centroids(topo, pts)
    th = np.asarray(t) / hour

    fig, axes = plt.subplots(1, 2, figsize=(9, 3.6))
    # height-band averages pick out the dipping interlayers vs salt body
    z = cc[:, 2]
    bands = np.linspace(z.min(), z.max(), 6)
    for lo, hi in zip(bands[:-1], bands[1:]):
        sel = (z >= lo) & (z < hi)
        if sel.any():
            axes[0].plot(th, q[:, sel].mean(axis=1) / MPa, "-", lw=1,
                         label=f"z in [{lo:.0f},{hi:.0f}) m")
    axes[0].set_xlabel("time (h)")
    axes[0].set_ylabel("band-mean von Mises (MPa)")
    axes[0].legend(fontsize=7)

    try:
        _, u, upts, _ = pp.read_timeseries(out_root, "u")
        roof = upts[:, 2].argmax()
        axes[1].plot(th[:u.shape[0]], u[:, roof, 2] * 1e3, "-o", ms=3)
        axes[1].set_xlabel("time (h)")
        axes[1].set_ylabel("roof settlement u_z (mm)")
    except Exception:
        axes[1].set_visible(False)
    for ax in axes:
        if ax.get_visible():
            ax.grid(True, alpha=0.4)
    fig.tight_layout()
    png = os.path.join(out_root, "results.png")
    fig.savefig(png, dpi=130)
    print(f"wrote {png}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
