"""Multi-model creep calibration on staged triaxial schedules.

The port's twin of examples/mechanics/MaterialCalibration/
calibrate_multimodel.py, the two-model calibration workflow:

  (a) the SafeInCave chain - Spring + Kelvin + DislocationCreep (scalar
      axial form: exact Kelvin relaxation per step, forward-Euler
      dislocation creep on the interpolated schedule);
  (b) Munson-Dawson - Spring + MunsonDawsonCreep, on the port element's own
      stress-only fields (``MunsonDawsonCreep._md_fields``: deviator, von
      Mises, steady-state rate, transient strain limit) so the calibrated
      parameters drop straight into the FE solver.

The fits take exact ``torch.autograd`` gradients through the integrators
(``sc.calibrate``: Adam in log space).  Model (a) is one lower-triangular
product of decay factors and a cumulative sum over the whole schedule;
model (b) advances the transient state by backward Euler (12 Newton steps
per time step, the residue's derivative in closed form).

Data: pass a ZW_TCC*.csv path (time_h, sigma1_MPa, sigma3_MPa,
eps_axial_pct columns) to fit lab data; with no argument, synthetic
observations (1 % noise from a seeded ``torch.Generator``) are generated
from known parameters and recovered.  ``steps`` is the number of Adam
steps of each fit (400, as in the JAX script).
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

import safeincave_torch as sc  # noqa: E402
from safeincave_torch.materials.creep import MunsonDawsonCreep  # noqa: E402

F64 = torch.float64
HOUR = 3600.0
R_GAS = 8.32
T_LAB = 298.0


# -- schedule ---------------------------------------------------------------- #
def build_stress_schedule(time_h, sigma1_MPa, sigma3_MPa, dt_hours=0.25):
    """Fine time grid with stresses interpolated from lab waypoints.

    Returns (t_s, sigma1_Pa, sigma3_Pa, idx_start); t=0 is where deviatoric
    loading (sigma1 - sigma3 > 1 MPa) begins.
    """
    time_h = np.asarray(time_h, dtype=float)
    sigma1 = np.asarray(sigma1_MPa, dtype=float)
    sigma3 = np.asarray(sigma3_MPa, dtype=float)
    mask = (sigma1 - sigma3) > 1.0
    if not np.any(mask):
        raise ValueError("No deviatoric loading found in data")
    idx = int(np.argmax(mask))
    t_lab = (time_h[idx:] - time_h[idx]) * HOUR
    n = int(np.ceil((time_h[-1] - time_h[idx]) / dt_hours))
    t_s = np.linspace(0.0, t_lab[-1], n + 1)
    s1 = np.interp(t_s, t_lab, sigma1[idx:] * 1e6)
    s3 = np.interp(t_s, t_lab, sigma3[idx:] * 1e6)
    return t_s, s1, s3, idx


def _on(x, like):
    return torch.as_tensor(np.asarray(x, dtype=np.float64),
                           device=like.device)


# -- model (a): SafeInCave chain, scalar axial form -------------------------- #
def sic_axial_strain(params, t_s, s1, s3):
    """Axial creep strain of Spring+Kelvin+DislocationCreep (+elastic).

    params: A, n (dislocation, Q fixed at 51600), eta, E1 (Kelvin), float64
    tensors on one device.  Kelvin relaxes exactly over each step toward
    sd/E1 at the step's end stress; dislocation creep is forward Euler.
    """
    A = params["A"]
    t = _on(t_s, A)
    sd = _on(s1 - s3, A)[1:]
    dts = torch.diff(t)
    A_bar = torch.exp(torch.log(A) - 51600.0 / (R_GAS * T_LAB))
    # eps_k after step i: sum over j <= i of (sd_j / E1)(1 - decay_j)
    # times the decay from t_j to t_i, decay = exp(-E1 dt / eta)
    lag = t[1:, None] - t[None, 1:]
    w = torch.exp(-params["E1"] / params["eta"] * lag.clamp(min=0.0)) \
        * torch.ones_like(lag).tril()
    eps_k = w @ (sd / params["E1"]
                 * -torch.expm1(-params["E1"] * dts / params["eta"]))
    eps_d = torch.cumsum(A_bar * torch.abs(sd) ** params["n"]
                         * torch.sign(sd) * dts, 0)
    return torch.cat([torch.zeros(1, dtype=F64, device=A.device),
                      eps_k + eps_d])


# -- model (b): Munson-Dawson on the element's fields ------------------------ #
def _transient(zeta, e_star, delta_cap, delta):
    """The transient function F(zeta) of MunsonDawsonCreep and dF/dzeta:
    work hardening below the transient limit, recovery above it, each
    exponent clipped to +-50 as the element does."""
    x = 1.0 - zeta / e_star
    below = zeta <= e_star
    c = torch.where(below, delta_cap, -delta)
    arg = c * x * x
    F = torch.exp(torch.clamp(arg, -50.0, 50.0))
    inside = (arg > -50.0) & (arg < 50.0)
    dF = torch.where(inside, F * c * (-2.0 * x / e_star), 0.0)
    return F, dF


def md_axial_strain(params, t_s, s1, s3, n_newton=12):
    """Axial creep strain of the Munson-Dawson element under the schedule.

    The triaxial stress diag(-s3, -s3, -s1) (SafeInCave signs) goes through
    the element's ``_md_fields`` for every step at once: deviator, von
    Mises, steady-state rate and transient limit depend on the stress only.
    The transient ISV zeta advances by BACKWARD Euler (Newton on the
    element's residue r = zeta - zeta_old - (F - 1) edot_ss dt): the
    transient relaxation time is seconds at lab stresses, far stiffer than
    any practical dt.  The strain increment uses the exact identity
    d(eps_transient) = d(zeta) * 1.5 dev/sigma.  params: A, n, K0, delta;
    the other MD constants are fixed.
    """
    A = params["A"]
    dev_ = A.device

    def const(v):
        return torch.tensor(v, dtype=F64, device=dev_)

    p = {"A": A, "Q": const(51600.0), "n": params["n"], "K0": params["K0"],
         "c": const(0.0), "m": const(3.0), "alpha_w": const(-13.2),
         "beta_w": const(-7.738), "delta": params["delta"],
         "mu": const(12.4e9)}
    dts = torch.diff(_on(t_s, A))
    s1_t, s3_t = _on(s1, A)[1:], _on(s3, A)[1:]
    z = torch.zeros_like(s1_t)
    sv6 = torch.stack([-s3_t, -s3_t, -s1_t, z, z, z], dim=-1)
    T = torch.full_like(s1_t, T_LAB)
    dev, sig, edot_ss, e_star, _ = MunsonDawsonCreep._md_fields(sv6, z, T, p)
    ratio = torch.clamp(sig / torch.clamp(p["mu"], min=1.0), min=1e-30)
    delta_cap = p["alpha_w"] + p["beta_w"] * torch.log10(ratio)
    proj = 1.5 * dev[:, 2] / sig
    creep = edot_ss * dts

    zeta_old = torch.zeros((), dtype=F64, device=dev_)
    eps_zz = torch.zeros((), dtype=F64, device=dev_)
    out = [eps_zz]
    for k in range(len(dts)):
        zeta = zeta_old
        for _ in range(n_newton):
            F, dF = _transient(zeta, e_star[k], delta_cap[k], p["delta"])
            r = zeta - zeta_old - (F - 1.0) * creep[k]
            h = 1.0 - dF * creep[k]
            h = torch.where(torch.abs(h) > 1e-12, h, 1.0)
            zeta = torch.clamp(zeta - r / h, min=0.0)
        # steady-state + exact transient increment (zeta IS the transient
        # equivalent strain: zeta_dot = (F-1) edot_ss)
        eps_zz = eps_zz + proj[k] * (creep[k] + (zeta - zeta_old))
        out.append(eps_zz)
        zeta_old = zeta
    return torch.stack(out)


TRUE_SIC = {"A": 1.9e-20, "n": 3.0, "eta": 1.05e14, "E1": 10e9}
TRUE_MD = {"A": 1.9e-20, "n": 3.0, "K0": 1e7, "delta": 0.58}


def staged_schedule():
    """Staged deviatoric loading with a final UNLOAD (ZW_TCC pattern).

    The unload stage matters for Munson-Dawson: the recovery exponent
    delta only acts when zeta > eps_t_star, i.e. after a stress DROP -
    a monotonic schedule leaves delta unidentifiable."""
    time_h = [0, 1, 24, 25, 72, 73, 120, 121, 168]
    sigma1 = [5, 14, 14, 18, 18, 22, 22, 12, 12]     # MPa
    sigma3 = [5, 4, 4, 4, 4, 4, 4, 4, 4]
    return build_stress_schedule(time_h, sigma1, sigma3, dt_hours=0.5)


def load_csv(path):
    d = np.genfromtxt(path, delimiter=",", names=True)
    cols = d.dtype.names
    return (d[cols[0]], d[cols[1]], d[cols[2]],
            d[cols[3]] / 100.0 if len(cols) > 3 else None)


def observed_records(t_s, s1, s3, device):
    """Both models' strains at the true parameters with one 1 % noise
    vector from a seeded ``torch.Generator`` (drawn on the host)."""
    gen = torch.Generator().manual_seed(0)
    noise = 1 + 0.01 * torch.randn(len(t_s), generator=gen, dtype=F64)

    def at(true, model):
        with torch.no_grad():
            clean = model({k: torch.tensor(v, dtype=F64, device=device)
                           for k, v in true.items()}, t_s, s1, s3)
        return (clean.cpu() * noise).numpy()

    return at(TRUE_SIC, sic_axial_strain), at(TRUE_MD, md_axial_strain)


def main(csv_path=None, steps=400, device=None):
    device = torch.device(device) if device else sc.default_device()
    if csv_path:
        time_h, s1_MPa, s3_MPa, eps_obs = load_csv(csv_path)
        t_s, s1, s3, idx = build_stress_schedule(time_h, s1_MPa, s3_MPa)
        obs_sic = obs_md = np.interp(
            t_s, (np.asarray(time_h)[idx:] - time_h[idx]) * HOUR,
            eps_obs[idx:])
    else:
        t_s, s1, s3, _ = staged_schedule()
        obs_sic, obs_md = observed_records(t_s, s1, s3, device)

    scale = max(np.abs(obs_sic).max(), 1e-12)
    fitted_sic, hist = sc.calibrate(
        lambda p: sic_axial_strain(p, t_s, s1, s3),
        params0={"A": 5e-20, "n": 2.5, "eta": 3e14, "E1": 5e9},
        observed=obs_sic, lr=0.05, steps=steps, loss_scale=scale,
        device=device)
    print("SafeInCave chain fit:")
    for k, v in fitted_sic.items():
        print(f"  {k}: {float(v):.4e}   (true {TRUE_SIC[k]:.4e})")
    print(f"  loss {hist[0]:.3e} -> {hist[-1]:.3e}")

    scale = max(np.abs(obs_md).max(), 1e-12)
    fitted_md, hist = sc.calibrate(
        lambda p: md_axial_strain(p, t_s, s1, s3),
        params0={"A": 5e-20, "n": 2.5, "K0": 3e6, "delta": 0.3},
        observed=obs_md, lr=0.05, steps=steps, loss_scale=scale,
        device=device)
    print("Munson-Dawson fit:")
    for k, v in fitted_md.items():
        print(f"  {k}: {float(v):.4e}   (true {TRUE_MD[k]:.4e})")
    print(f"  loss {hist[0]:.3e} -> {hist[-1]:.3e}")
    return fitted_sic, fitted_md


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
