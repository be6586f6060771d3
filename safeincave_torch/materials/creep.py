"""Kelvin-Voigt viscoelasticity and dislocation creep.

Port of ``Viscoelastic`` and ``DislocationCreep`` from
``safeincave_tpu/materials/creep.py``.  Rates are batched functions of the
tensorial-Voigt stress (SafeInCave sign convention, Pa).
"""
from __future__ import annotations

import torch

from ..linalg import inv6x6_fast
from ..utils import iso6
from .base import NonElasticElement, apply66
from .elastic import isotropic_C

_R_GAS = 8.32  # gas constant value of the reference model


def _dev6(sv6):
    mean = (sv6[:, 0] + sv6[:, 1] + sv6[:, 2]) / 3.0
    return sv6 - mean[:, None] * iso6(sv6)


def _von_mises6_floor(sv6, floor):
    """Von Mises with the floor inside the sqrt, so the derivative stays
    finite at zero deviatoric stress.  In float32 the squared floor must stay
    above the underflow threshold (1e-30 squared flushes to 0), else the
    derivative there is NaN."""
    if sv6.dtype == torch.float32:
        floor = max(floor, 1e-15)
    xx, yy, zz, xy, xz, yz = sv6.unbind(-1)
    arg = 0.5 * ((xx - yy) ** 2 + (xx - zz) ** 2 + (yy - zz) ** 2
                 + 6.0 * (xy ** 2 + xz ** 2 + yz ** 2))
    return torch.sqrt(torch.clamp(arg, min=floor * floor))


class DislocationCreep(NonElasticElement):
    """Power-law creep: rate = A exp(-Q/RT) q^(n-1) s."""

    def __init__(self, A, Q, n, name: str = "creep", device=None):
        super().__init__(len(A), name, device)
        self.params = {"A": self._tensor(A), "Q": self._tensor(Q),
                       "n": self._tensor(n)}
        self.R = _R_GAS

    def _rate(self, sv6, isv, T, p):
        dev = _dev6(sv6)
        # the floor keeps d(q^(n-1))/d(sigma) finite at zero deviatoric
        # stress, far below any physical stress
        q = _von_mises6_floor(sv6, 1e-30)
        # log space: q**(n-1) alone overflows for large n at cavern stresses
        A_bar = torch.exp(torch.log(p["A"]) - p["Q"] / _R_GAS / T
                          + (p["n"] - 1.0) * torch.log(q))
        return A_bar[:, None] * dev


class Viscoelastic(NonElasticElement):
    """Kelvin-Voigt viscoelasticity.

    rate = G : (sigma - C1 : (eps_old + phi1 rate_old)), with the closed
    form tangent G = (eta I + phi2 C1)^-1.
    """

    def __init__(self, eta, E, nu, name: str = "kelvin_voigt", device=None):
        super().__init__(len(E), name, device)
        self.params = {"eta": self._tensor(eta), "E": self._tensor(E),
                       "nu": self._tensor(nu)}
        self.C1 = torch.as_tensor(isotropic_C(E, nu), device=self.device)
        self._C1_32 = self.C1.to(torch.float32)

    def _C1_for(self, dtype):
        return self._C1_32 if dtype == torch.float32 else self.C1

    def f_tangent(self, state, sv6, T, dt, theta):
        phi2 = dt * (1 - theta)
        eye = torch.eye(6, dtype=sv6.dtype, device=sv6.device)
        mat = (self._p(sv6.dtype)["eta"][:, None, None] * eye
               + phi2 * self._C1_for(sv6.dtype))
        E_op, _ = inv6x6_fast(mat)
        new = dict(state)
        new["G"] = E_op
        new["B"] = torch.zeros_like(state["B"])
        return new

    def f_rate_value(self, state, sv6, phi1, T):
        hist = state["eps_old"] + phi1 * state["rate_old"]
        drive = sv6 - apply66(self._C1_for(sv6.dtype), hist)
        return apply66(state["G"], drive)
