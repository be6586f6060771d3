"""Linear elastic and thermoelastic elements (port of
safeincave_tpu/materials/elastic.py).

Stiffness and compliance are closed-form isotropic operators, built on the
host in numpy once per material.  The thermal strain is a device operation:
the coupled step evaluates it once per time step.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import default_device
from ..utils import dotdot, iso6, voigt_to_tensor
from .base import _as_voigt


def isotropic_C(E, nu) -> np.ndarray:
    """Isotropic stiffness (n, 6, 6) in tensorial Voigt; shear diagonal is
    a0 (1 - 2 nu) = 2G."""
    E = np.asarray(E, dtype=np.float64)
    nu = np.asarray(nu, dtype=np.float64)
    a0 = E / ((1 + nu) * (1 - 2 * nu))
    C = np.zeros((E.shape[0], 6, 6))
    for k in range(3):
        C[:, k, k] = a0 * (1 - nu)
        C[:, k + 3, k + 3] = a0 * (1 - 2 * nu)
    for i in range(3):
        for j in range(3):
            if i != j:
                C[:, i, j] = a0 * nu
    return C


def isotropic_C_inv(E, nu) -> np.ndarray:
    """Closed-form compliance: 1/E on the normal block, 1/(2G) on shear."""
    E = np.asarray(E, dtype=np.float64)
    nu = np.asarray(nu, dtype=np.float64)
    Ci = np.zeros((E.shape[0], 6, 6))
    G2 = E / (1 + nu)  # 2G
    for k in range(3):
        Ci[:, k, k] = 1.0 / E
        Ci[:, k + 3, k + 3] = 1.0 / G2
    for i in range(3):
        for j in range(3):
            if i != j:
                Ci[:, i, j] = -nu / E
    return Ci


class Spring:
    """Linear isotropic elastic element."""

    def __init__(self, E, nu, name: str = "spring"):
        self.E = np.asarray(E, dtype=np.float64)
        self.nu = np.asarray(nu, dtype=np.float64)
        self.name = name
        self.n_elems = self.E.shape[0]
        self.eps_e = None

    def initialize(self):
        self.C = isotropic_C(self.E, self.nu)
        self.C_inv = isotropic_C_inv(self.E, self.nu)
        # deviatoric operators: 2G and 1/(2G) on the whole diagonal
        G2 = self.E / (1 + self.nu)
        eye = np.eye(6)[None]
        self.C_tilde = G2[:, None, None] * eye
        self.C_tilde_inv = (1.0 / G2)[:, None, None] * eye
        self.K = self.E / (3 * (1 - 2 * self.nu))

    def compute_eps_e(self, stress):
        """Elastic strain from stress via the compliance."""
        sv = _as_voigt(stress)
        C_inv = torch.as_tensor(self.C_inv, device=sv.device)
        self.eps_e = voigt_to_tensor(dotdot(C_inv, sv))


class Thermoelastic:
    """Thermal strain eps_th = alpha dT I."""

    def __init__(self, alpha, name: str = "thermoelastic", device=None):
        self.device = torch.device(device) if device else default_device()
        self.alpha = torch.as_tensor(np.asarray(alpha, dtype=np.float64),
                                     device=self.device)
        self.name = name
        self.n_elems = self.alpha.shape[0]
        self.eps_th_v = torch.zeros((self.n_elems, 6), dtype=torch.float64,
                                    device=self.device)

    def eps_th_voigt(self, dT: torch.Tensor) -> torch.Tensor:
        """(E, 6) Voigt thermal strain of the temperature change dT (E,),
        in dT's dtype: a float32 dT (the f32 fixed-point sweep) stays
        float32."""
        return (self.alpha.to(dT.dtype) * dT)[:, None] * iso6(dT)

    def compute_eps_th(self, dT):
        self.eps_th_v = self.eps_th_voigt(
            torch.as_tensor(dT, dtype=torch.float64).to(self.device))

    @property
    def eps_th(self):
        return voigt_to_tensor(self.eps_th_v)
