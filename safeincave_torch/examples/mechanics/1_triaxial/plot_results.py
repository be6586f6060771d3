"""Post-process the triaxial run: strain-mechanism split over time.

The port's twin of examples/mechanics/1_triaxial/plot_results.py: the same figure from
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
    out_root = out_root or os.path.join(here, "output", "case_0")

    fig, axes = plt.subplots(1, 2, figsize=(9, 3.6))
    for field, label in (("eps_tot", "total"), ("eps_ve", "viscoelastic"),
                         ("eps_cr", "creep"), ("eps_vp", "viscoplastic")):
        try:
            t, eps, _, _ = pp.read_timeseries(out_root, field)
        except Exception:
            continue
        # volume-mean axial component (zz): tensor fields are written
        # either flat 3x3 (..., 9) or Voigt (..., 6); zz is index 8 / 2
        w = 9 if eps.size % (eps.shape[0] * 9) == 0 and eps.shape[-1] != 6 \
            else 6
        zz = 8 if w == 9 else 2
        ez = eps.reshape(eps.shape[0], -1, w)[:, :, zz].mean(axis=1)
        axes[0].plot(np.asarray(t) / hour, 100 * ez, "-o", ms=3, label=label)
    axes[0].set_xlabel("time (h)")
    axes[0].set_ylabel("axial strain (%)")
    axes[0].legend(fontsize=8)

    try:
        t, fvp, _, _ = pp.read_timeseries(out_root, "Fvp")
        axes[1].plot(np.asarray(t) / hour, fvp.reshape(len(t), -1).max(axis=1),
                     "-o", ms=3)
        axes[1].set_ylabel("max yield function Fvp (-)")
        axes[1].set_xlabel("time (h)")
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
