"""Calibrate salt creep parameters against a REAL multi-stage lab record.

The port's twin of examples/mechanics/MaterialCalibration/
calibrate_labdata.py: an IfG multi-stage triaxial creep test on
Zuidwending rock salt (examples/mechanics/MaterialCalibration/data/
ZW_TCC4.csv, read in place), fitted with exact ``torch.autograd``
gradients through a piecewise-analytic forward model, then cross-checked
against the port's MaterialPointSimulator integration of the production
constitutive elements.

Model (axial strain, SafeInCave signs):
  elastic spring        eps_e  = C0^-1 : sigma          (E0, nu0 from the
                                                         record's dynamic
                                                         moduli)
  Kelvin-Voigt          eta eps_dot + C1 : eps = sigma  (fit eta1, E1)
  dislocation creep     eps_dot = A e^{-Q/RT} q^{n-1} dev(sigma)
                                                        (fit A, n; Q fixed
                                                         at the literature
                                                         value the reference
                                                         uses, Q/R ~ 6252 K)

Under the per-sample piecewise-constant stress the KV ODE and the creep
rate integrate in closed form (volumetric/deviatoric relaxation with
tau_v = eta/3K1, tau_d = eta/2G1), so the forward model is exact, cheap,
and differentiable; the relaxation over all samples is one lower-
triangular product of decay factors, so no loop runs over the record.

Outputs: fitted_params.json + calibration_labdata.png (data vs model +
residual panel) in ``--out`` (default: next to this script).

Run:  python calibrate_labdata.py [--csv ZW_TCC4.csv] [--steps 400]
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", "..", ".."))
sys.path.insert(0, HERE)

import safeincave_torch as sc  # noqa: E402
from lab_data import load_ifg_creep_csv  # noqa: E402

DATA = os.path.join(HERE, "..", "..", "..", "..", "examples", "mechanics",
                    "MaterialCalibration", "data")
F64 = torch.float64
R_GAS = 8.32            # reference MaterialProps.py:915 convention
Q_FIXED = 6252.0 * R_GAS   # J/mol; literature Q/R the reference fixes
NU1 = 0.25


def relax(target, times, tau):
    """x_k = target_k + (x_{k-1} - target_k) exp(-(t_k - t_{k-1}) / tau)
    from x_0 = 0, for every k at once: the sum over j <= k of
    target_j (1 - exp(-dt_j / tau)) exp(-(t_k - t_j) / tau)."""
    t = times[1:]
    lag = t[:, None] - t[None, :]
    below = torch.ones_like(lag).tril()
    w = torch.exp(-lag.clamp(min=0.0) / tau) * below
    return w @ (target * -torch.expm1(-torch.diff(times) / tau))


def make_forward(rec, device=None):
    """Differentiable forward model: params -> predicted lab strain
    increment (compression positive, relative to the first loaded sample).
    """
    def as_t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=device)
    times = as_t(rec["times_s"])
    s3 = as_t(rec["s3_Pa"])
    sd = as_t(rec["sdiff_Pa"])
    T_K = as_t(rec["T_K"])
    E0 = rec["meta"].get("Ed_GPa", 38.6) * 1e9
    nu0 = rec["meta"].get("vd", 0.25)

    # SafeInCave signs: compression negative
    sig_zz = -(s3 + sd)
    sig_rr = -s3
    tr_sig = sig_zz + 2 * sig_rr
    dev_zz = sig_zz - tr_sig / 3.0
    q = torch.clamp(sd, min=1e3)  # von Mises floor (Pa), as the element does

    eps_e_zz = (sig_zz - 2 * nu0 * sig_rr) / E0
    dts = torch.diff(times)

    def predict(params):
        eta1, E1 = params["eta1"], params["E1"]
        A, n = params["A"], params["n"]
        K1 = E1 / (3.0 * (1.0 - 2.0 * NU1))
        G1 = E1 / (2.0 * (1.0 + NU1))
        tau_v = eta1 / (3.0 * K1)
        tau_d = eta1 / (2.0 * G1)

        # KV: exact exponential relaxation toward the Kelvin-spring elastic
        # state under the stress held over each interval (left piecewise
        # constant)
        tr_kv = relax(tr_sig[:-1] / (3.0 * K1), times, tau_v)
        dev_kv = relax(dev_zz[:-1] / (2.0 * G1), times, tau_d)
        # dislocation creep: rate constant over each interval
        rate = torch.exp(torch.log(A) - Q_FIXED / R_GAS / T_K[:-1]
                         + (n - 1.0) * torch.log(q[:-1])) * dev_zz[:-1]
        eps_dc = torch.cumsum(rate * dts, 0)
        eps_ne = torch.cat([torch.zeros(1, dtype=F64, device=times.device),
                            tr_kv / 3.0 + dev_kv + eps_dc])
        eps_zz = eps_e_zz + eps_ne
        # lab convention: compression positive, relative to first sample
        pred = -(eps_zz - eps_zz[0])
        return pred

    return predict


def main(argv=None, device=None):
    """``argv``: the command line (default ``sys.argv[1:]``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", default=os.path.join(DATA, "ZW_TCC4.csv"))
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--no-plot", action="store_true")
    ap.add_argument("--out", default=HERE,
                    help="folder for fitted_params.json and the figure")
    args = ap.parse_args(argv)
    device = torch.device(device) if device else sc.default_device()

    rec = load_ifg_creep_csv(args.csv)
    observed = rec["eps_axial"] - rec["eps_axial"][0]
    print(f"record {rec['meta'].get('sample', '?')}: "
          f"{len(observed)} samples over {rec['times_s'][-1]/3600:.0f} h, "
          f"T = {rec['T_K'].mean()-273.15:.0f} C, "
          f"s3 = {rec['s3_Pa'].mean()/1e6:.1f} MPa, "
          f"sdiff stages up to {rec['sdiff_Pa'].max()/1e6:.1f} MPa")

    predict = make_forward(rec, device)
    params0 = {"A": 1e-36, "n": 4.0, "eta1": 1e14, "E1": 5e9}
    fitted, history = sc.calibrate(
        predict, params0, observed, lr=0.08, steps=args.steps,
        loss_scale=np.abs(observed).max(), device=device)
    fitted = {k: float(v) for k, v in fitted.items()}
    with torch.no_grad():
        pred = predict({k: torch.tensor(v, dtype=F64, device=device)
                        for k, v in fitted.items()}).cpu().numpy()
    rms = float(np.sqrt(np.mean((pred - observed) ** 2)))
    print("fitted:", {k: f"{v:.4g}" for k, v in fitted.items()})
    print(f"loss {history[0]:.3e} -> {history[-1]:.3e}, "
          f"RMS misfit {rms:.3e} strain "
          f"({100 * rms / max(observed.max(), 1e-12):.1f}% of peak)")

    # cross-check: the PRODUCTION constitutive stack (Spring + Viscoelastic
    # + DislocationCreep, materials/creep.py) integrated by the
    # MaterialPointSimulator under the same measured stress path
    one = np.ones(1)
    E0 = rec["meta"].get("Ed_GPa", 38.6) * 1e9
    nu0 = rec["meta"].get("vd", 0.25)
    mat = sc.Material(1, device=device)
    mat.add_to_elastic(sc.Spring(E0 * one, nu0 * one))
    mat.add_to_non_elastic(sc.Viscoelastic(fitted["eta1"] * one,
                                           fitted["E1"] * one, NU1 * one,
                                           device=device))
    mat.add_to_non_elastic(sc.DislocationCreep(fitted["A"] * one,
                                               Q_FIXED * one,
                                               fitted["n"] * one,
                                               device=device))
    mps = sc.MaterialPointSimulator(mat, theta=0.5,
                                    Temp=rec["T_K"].mean() * one)
    T = len(rec["times_s"])
    hist = np.zeros((T, 3, 3))
    hist[:, 0, 0] = hist[:, 1, 1] = -rec["s3_Pa"]
    hist[:, 2, 2] = -(rec["s3_Pa"] + rec["sdiff_Pa"])
    res = mps.run(hist, rec["times_s"])
    eps_zz = res["eps_total"][:, 0, 2, 2].cpu().numpy()
    mps_pred = -(eps_zz - eps_zz[0])
    mps_rms = float(np.sqrt(np.mean((mps_pred - observed) ** 2)))
    print(f"MaterialPointSimulator cross-check RMS: {mps_rms:.3e} "
          f"(analytic-vs-theta-scheme agreement "
          f"{np.abs(mps_pred - pred).max():.2e})")

    out = {
        "record": rec["meta"].get("sample", os.path.basename(args.csv)),
        "fixed": {"Q": Q_FIXED, "nu1": NU1, "E0": E0, "nu0": nu0,
                  "R": R_GAS},
        "fitted": fitted,
        "rms_strain": rms,
        "mps_rms_strain": mps_rms,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "fitted_params.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {os.path.join(args.out, 'fitted_params.json')}")

    if not args.no_plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        t_d = rec["times_s"] / 86400.0
        fig, (ax1, ax2) = plt.subplots(
            2, 1, figsize=(8, 7), sharex=True,
            gridspec_kw={"height_ratios": [3, 1]})
        ax1.plot(t_d, 100 * observed, "k.", ms=4, label="lab (IfG)")
        ax1.plot(t_d, 100 * pred, "-", lw=1.5,
                 label="fit (KV + dislocation creep)")
        ax1.plot(t_d, 100 * mps_pred, "--", lw=1.0,
                 label="MaterialPointSimulator cross-check")
        axr = ax1.twinx()
        axr.step(t_d, rec["sdiff_Pa"] / 1e6, where="post", color="0.6",
                 lw=0.8)
        axr.set_ylabel("sigma_diff [MPa]", color="0.5")
        ax1.set_ylabel("axial creep strain [%]")
        ax1.legend(loc="upper left")
        ax1.set_title(f"{out['record']} - fitted A={fitted['A']:.3g}, "
                      f"n={fitted['n']:.2f}, eta1={fitted['eta1']:.3g}, "
                      f"E1={fitted['E1']:.3g}")
        ax2.plot(t_d, 100 * (pred - observed), ".", ms=3)
        ax2.axhline(0, color="k", lw=0.5)
        ax2.set_xlabel("time [days]")
        ax2.set_ylabel("residual [%]")
        fig.tight_layout()
        png = os.path.join(args.out, "calibration_labdata.png")
        fig.savefig(png, dpi=120)
        print(f"wrote {png}")
    return out


if __name__ == "__main__":
    main()
