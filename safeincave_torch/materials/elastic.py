"""Linear elastic element (port of safeincave_tpu/materials/elastic.py).

Stiffness and compliance are closed-form isotropic operators, built on the
host in numpy once per material.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import dotdot, voigt_to_tensor
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
        self.K = self.E / (3 * (1 - 2 * self.nu))

    def compute_eps_e(self, stress):
        """Elastic strain from stress via the compliance."""
        sv = _as_voigt(stress)
        C_inv = torch.as_tensor(self.C_inv, device=sv.device)
        self.eps_e = voigt_to_tensor(dotdot(C_inv, sv))
