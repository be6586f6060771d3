"""Mohr-Coulomb digital-twin calibration on triaxial compression tests.

The port's twin of examples/mechanics/MaterialCalibration/
calibrate_triaxial.py.  The twin is ``sc.TriaxialSimulator.
run_compression`` - mixed control (axial strain rate at fixed radial
confinement) integrated with the port's theta-scheme constitutive
machinery - and the Mohr-Coulomb strength parameters are fitted with
exact ``torch.autograd`` gradients through the whole stress-strain history.

Workflow:
  1. Young's modulus from the initial elastic slope of S_diff(eps_axial)
     (closed form - no optimizer needed for the elastic branch).
  2. Cohesion + friction angle by gradient descent on the full curve at
     two confinements simultaneously (batched as two material points).

With no paths, synthetic "lab" curves are generated from known parameters
(1 % noise from a seeded ``torch.Generator``) and recovered; pass CSV paths
with (eps_axial_pct, S_diff_MPa) columns to fit measured data.  ``steps``
is the number of Adam steps (250, as in the JAX script).
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

import safeincave_torch as sc  # noqa: E402

F64 = torch.float64
MPa = 1e6
DEG = np.pi / 180.0

# two confinement levels, SafeInCave signs (compression negative)
SR = np.array([-2.0 * MPa, -5.0 * MPa])
E_TRUE, NU = 25e9, 0.3
# the element's units: cohesion / sigma_t in MPa, compression-positive
TRUE = {"cohesion": 3.0, "friction": 30.0 * DEG}
DILATION = 10.0 * DEG
# Perzyna overstress viscosity: large enough that the stress relaxes to
# the yield surface within a few load steps (near-rate-independent limit)
MU_1, N_1 = 2e-5, 1.5

EPS_RATE = 1e-5            # 1/s axial strain rate (ram velocity analog)
T_END = 2000.0             # -> 2 % axial strain
TIMES = np.linspace(0.0, T_END, 81)


def _per_point(x, n):
    """``x`` at each of ``n`` material points, keeping a tensor's device
    and autograd history."""
    if isinstance(x, torch.Tensor):
        return x * torch.ones(n, dtype=F64, device=x.device)
    return x * np.ones(n)


def run_twin(cohesion, friction, sample_scale=1.0, device=None):
    """S_diff histories (T, 2) for both confinements, differentiable in
    (cohesion, friction); ``device`` is taken from them when they are
    tensors."""
    n = len(SR)
    if isinstance(cohesion, torch.Tensor):
        device = cohesion.device
    mat = sc.Material(n, device=device)
    mat.add_to_elastic(sc.Spring(E_TRUE * np.ones(n), NU * np.ones(n)))
    mat.add_to_non_elastic(sc.MohrCoulombViscoplastic(
        mu_1=MU_1 * np.ones(n), N_1=N_1 * np.ones(n),
        cohesion=_per_point(cohesion, n),
        friction_angle=_per_point(friction, n),
        dilation_angle=DILATION * np.ones(n), sigma_t=np.ones(n),
        device=device))
    sim = sc.TriaxialSimulator(mat, theta=0.5)
    # prescribed total axial strain: isotropic elastic state at t=0, then
    # the ram moves at EPS_RATE (compression -> increasingly negative)
    Ci = mat.C_inv.cpu().numpy()
    eps0 = (Ci[:, 2, 0] + Ci[:, 2, 1] + Ci[:, 2, 2]) * SR
    ez = eps0[None, :] - EPS_RATE * TIMES[:, None] * sample_scale
    res = sim.run_compression(SR, ez, TIMES)
    return res["S_diff"]


def observed_curves(device=None):
    """The true parameters' curves with 1 % noise from a seeded
    ``torch.Generator`` (drawn on the host)."""
    clean = run_twin(TRUE["cohesion"], TRUE["friction"],
                     device=device).detach().cpu()
    gen = torch.Generator().manual_seed(0)
    noise = torch.randn(clean.shape, generator=gen, dtype=F64)
    return (clean * (1 + 0.01 * noise)).numpy()


def fit(observed, steps=250, device=None):
    fitted, hist = sc.calibrate(
        lambda p: run_twin(p["cohesion"], p["friction"]),
        params0={"cohesion": 1.5, "friction": 22.0 * DEG},
        observed=observed, lr=0.08, steps=steps,
        loss_scale=float(np.abs(observed).max()), device=device)
    return fitted, hist


def main(argv=None, steps=250, device=None):
    """``argv``: CSV paths (default ``sys.argv[1:]``)."""
    device = torch.device(device) if device else sc.default_device()
    paths = sys.argv[1:] if argv is None else argv
    if paths:
        curves = []
        for path in paths:
            arr = np.loadtxt(path, delimiter=",", skiprows=1)
            # columns: eps_axial_pct, S_diff_MPa -> resample onto TIMES
            eps = EPS_RATE * TIMES * 100.0
            curves.append(np.interp(eps, arr[:, 0], arr[:, 1]) * MPa)
        observed = np.stack(curves, axis=1)
    else:
        observed = observed_curves(device)

    # elastic branch check: initial slope == E (uniaxial increment at
    # constant radial stress has d S_diff / d eps_axial = -E); use the
    # first step, before the weaker confinement reaches yield
    k = 1
    slope = ((observed[k, 1] - observed[0, 1])
             / (EPS_RATE * (TIMES[k] - TIMES[0])))
    print(f"elastic slope -> E ~ {abs(slope)/1e9:.1f} GPa "
          f"(true {E_TRUE/1e9:.1f})")

    fitted, hist = fit(observed, steps, device)
    print(f"fitted cohesion  = {float(fitted['cohesion']):.3f} MPa "
          f"(true {TRUE['cohesion']:.3f})")
    print(f"fitted friction  = {float(fitted['friction'])/DEG:.2f} deg "
          f"(true {TRUE['friction']/DEG:.2f})")
    print(f"loss: {hist[0]:.3e} -> {hist[-1]:.3e}")
    return fitted


if __name__ == "__main__":
    main()
