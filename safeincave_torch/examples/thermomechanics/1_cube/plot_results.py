"""Post-process the TM cube run: thermal expansion vs stress response.

The port's twin of examples/thermomechanics/1_cube/plot_results.py: the same figure from
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
    out_root = out_root or os.path.join(here, "output", "tm_cube")

    t_T, T, _, _ = pp.read_timeseries(os.path.join(out_root, "heat"), "T")
    t_u, u, upts, _ = pp.read_timeseries(os.path.join(out_root, "mom"), "u")
    t_q, q, _, _ = pp.read_timeseries(os.path.join(out_root, "mom"),
                                      "q_elems")
    top = upts[:, 2].argmax()

    fig, axes = plt.subplots(1, 3, figsize=(12, 3.4))
    axes[0].plot(np.asarray(t_T) / hour, T.reshape(T.shape[0], -1)
                 .mean(axis=1), "-o", ms=3)
    axes[0].set_ylabel("mean temperature (K)")
    axes[1].plot(np.asarray(t_u) / hour, u[:, top, 2] * 1e3, "-o", ms=3)
    axes[1].set_ylabel("top displacement u_z (mm)")
    axes[2].plot(np.asarray(t_q) / hour, q.mean(axis=1) / MPa, "-o", ms=3)
    axes[2].set_ylabel("mean von Mises (MPa)")
    for ax in axes:
        ax.set_xlabel("time (h)")
        ax.grid(True, alpha=0.4)
    fig.tight_layout()
    png = os.path.join(out_root, "results.png")
    fig.savefig(png, dpi=130)
    print(f"wrote {png}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
