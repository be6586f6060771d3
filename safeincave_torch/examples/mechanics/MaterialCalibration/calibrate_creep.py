"""Calibrate creep parameters against a triaxial strain-time record.

The port's twin of examples/mechanics/MaterialCalibration/
calibrate_creep.py: the differentiable material-point model gives exact
gradients (``torch.autograd``) through the closed-form creep strain, no
finite differences.

Here synthetic "lab data" is generated from known parameters (1 % noise
from a seeded ``torch.Generator``) and recovered.  Replace ``observed``
with a measured axial-strain time series to fit real creep tests.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

import safeincave_torch as sc  # noqa: E402

F64 = torch.float64
# triaxial stress state: 4 MPa confinement, 14 MPa axial (SafeInCave signs)
SIG = np.diag([-4e6, -4e6, -14e6])
TIMES = np.linspace(0.0, 48 * 3600.0, 49)
TEMP = 298.0

TRUE = {"A": 1.9e-20, "Q": 51600.0, "n": 3.0}


def axial_creep_strain(params):
    """Closed-form dislocation-creep axial strain under constant stress.

    (Under constant stress the theta-scheme is exact, so the analytic
    expression doubles as the fast differentiable forward model.)
    ``params`` holds float64 tensors on one device.
    """
    dev = params["A"].device
    dev_zz = SIG[2, 2] - np.trace(SIG) / 3.0
    q = abs(SIG[2, 2] - SIG[0, 0])
    A_bar = params["A"] * torch.exp(
        -torch.tensor(TRUE["Q"], dtype=F64, device=dev) / 8.32 / TEMP) \
        * q ** (params["n"] - 1.0)
    return A_bar * dev_zz * torch.as_tensor(TIMES, device=dev)


def observed_record(device):
    """The true parameters' strain with 1 % noise from a seeded
    ``torch.Generator`` (drawn on the host, so every device sees the same
    record)."""
    clean = axial_creep_strain({k: torch.tensor(v, dtype=F64, device=device)
                                for k, v in TRUE.items()}).cpu()
    gen = torch.Generator().manual_seed(0)
    noise = torch.randn(clean.shape, generator=gen, dtype=F64)
    return (clean * (1 + 0.01 * noise)).numpy()


def main(device=None):
    device = torch.device(device) if device else sc.default_device()
    observed = observed_record(device)

    fitted, history = sc.calibrate(
        axial_creep_strain,
        params0={"A": 5e-20, "n": 2.5},
        observed=observed,
        lr=0.05, steps=300,
        loss_scale=np.abs(observed).max(), device=device)

    print("fitted:", {k: float(v) for k, v in fitted.items()})
    print("true:  ", {k: TRUE[k] for k in fitted})
    print(f"loss: {history[0]:.3e} -> {history[-1]:.3e}")

    # cross-check with the full material-point integrator
    one = np.ones(1)
    mat = sc.Material(1, device=device)
    mat.add_to_elastic(sc.Spring(102e9 * one, 0.3 * one))
    mat.add_to_non_elastic(sc.DislocationCreep(
        fitted["A"] * one, TRUE["Q"] * one, fitted["n"] * one,
        device=device))
    mps = sc.MaterialPointSimulator(mat, theta=0.5)
    res = mps.run(np.broadcast_to(SIG, (len(TIMES), 3, 3)), TIMES)
    model_axial = res["eps_ne"][:, 0, 2, 2].cpu().numpy()
    rms = np.sqrt(np.mean((model_axial - observed) ** 2))
    print(f"material-point RMS misfit: {rms:.3e}")
    return fitted


if __name__ == "__main__":
    main()
