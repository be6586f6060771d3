"""Composite material container (port of safeincave_tpu/materials/material.py).

Aggregates the elastic stiffness, the thermoelastic strain elements, the
thermal properties and the inelastic G/B operators, and builds the
consistent tangent CT = (C_inv + dt(1-theta) G)^-1 with the reference's
per-element elastic fallback on singular tangents.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import default_device
from ..linalg import inv6x6, inv6x6_fast
from .base import _as_voigt


class Material:
    def __init__(self, n_elems: int, device=None):
        self.n_elems = n_elems
        self.device = torch.device(device) if device else default_device()
        self.elems_ne = []
        self.elems_th = []
        self.elems_e = []
        self._C = np.zeros((n_elems, 6, 6))
        self._C_inv = np.zeros((n_elems, 6, 6))
        self._C_tilde = np.zeros((n_elems, 6, 6))
        self._C_tilde_inv = np.zeros((n_elems, 6, 6))
        self._set_elastic()

    def _set_elastic(self):
        self.C = torch.as_tensor(self._C, device=self.device)
        self.C_inv = torch.as_tensor(self._C_inv, device=self.device)
        self.C_tilde = torch.as_tensor(self._C_tilde, device=self.device)
        self.C_tilde_inv = torch.as_tensor(self._C_tilde_inv,
                                           device=self.device)
        # inv(C_inv) on the host: the singular-tangent fallback
        self._CT_el = torch.as_tensor(np.linalg.inv(self._C_inv)
                                      if self.elems_e else self._C,
                                      device=self.device)
        # float32 shadows for the f32 fixed-point sweep
        self._f32 = (self.C_inv.to(torch.float32),
                     self._CT_el.to(torch.float32))

    def set_density(self, density):
        self.density = np.asarray(density, dtype=np.float64)

    def set_specific_heat_capacity(self, cp):
        self.cp = np.asarray(cp, dtype=np.float64)

    def set_thermal_conductivity(self, k):
        self.k = np.asarray(k, dtype=np.float64)

    def set_thermal_expansion(self, alpha_th):
        self.alpha_th = np.asarray(alpha_th, dtype=np.float64)

    def add_to_elastic(self, elem):
        elem.initialize()
        self._C = self._C + elem.C
        self._C_inv = self._C_inv + elem.C_inv
        self._C_tilde = self._C_tilde + elem.C_tilde
        self._C_tilde_inv = self._C_tilde_inv + elem.C_tilde_inv
        self.elems_e.append(elem)
        self._set_elastic()
        self.K = elem.K
        self.E = elem.E
        self.ShearMod = 3 * self.K * self.E / (9 * self.K - self.E)

    def add_to_non_elastic(self, elem):
        self.elems_ne.append(elem)

    def add_to_thermoelastic(self, elem):
        self.elems_th.append(elem)

    def f_tangent_all(self, states, sv6, T, dt, theta):
        """Per-element tangents + summed (G, B)."""
        G = torch.zeros((self.n_elems, 6, 6), dtype=sv6.dtype,
                        device=sv6.device)
        B = torch.zeros((self.n_elems, 6), dtype=sv6.dtype,
                        device=sv6.device)
        new_states = []
        for elem, st in zip(self.elems_ne, states):
            st = elem.f_tangent(st, sv6, T, dt, theta)
            G = G + st["G"]
            B = B + st["B"]
            new_states.append(st)
        return new_states, G, B

    def f_CT(self, G, dt, theta):
        """CT = (C_inv + dt(1-theta) G)^-1 with the elastic fallback, in
        G's dtype."""
        if G.dtype == torch.float32:
            C_inv, fallback = self._f32
        else:
            C_inv, fallback = self.C_inv, self._CT_el
        mat = C_inv + dt * (1 - theta) * G
        CT, ok = inv6x6_fast(mat)
        return torch.where(ok[:, None, None], CT, fallback)

    # -- reference-compatible mutating API -------------------------------- #
    def compute_G_B(self, stress, dt, theta, T):
        sv6 = _as_voigt(stress).to(self.device)
        T = torch.as_tensor(T, dtype=torch.float64).to(self.device)
        states, self.G, self.B6 = self.f_tangent_all(
            [e.state for e in self.elems_ne], sv6, T, dt, theta)
        for e, st in zip(self.elems_ne, states):
            e.state = st

    def compute_CT(self, dt, theta):
        self.CT = self.f_CT(self.G, dt, theta)

    def _sum_states(self, compute, keys):
        """Run ``compute`` on every inelastic element and sum its state
        entries ``keys`` over the elements."""
        sums = None
        for e in self.elems_ne:
            getattr(e, compute)()
            vals = [e.state[k] for k in keys]
            sums = vals if sums is None else [a + b
                                              for a, b in zip(sums, vals)]
        return sums

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=torch.float64, device=self.device)

    def compute_T_IT(self):
        n = self.n_elems
        self.IT, self.T6 = self._sum_states("compute_T_IT", ("IT", "T")) \
            or (self._zeros(n, 6, 6), self._zeros(n, 6))

    def compute_Bvol_Tvol(self, stress=None, dt=None):
        n = self.n_elems
        self.B_vol, self.T_vol = self._sum_states(
            "compute_Bvol_Tvol", ("B_vol", "T_vol")) \
            or (self._zeros(n), self._zeros(n))

    def compute_Gtilde_Btilde(self, stress=None, dt=None):
        n = self.n_elems
        self.G_tilde, self.B_tilde6 = self._sum_states(
            "compute_Gtilde_Btilde", ("G_tilde", "B_tilde")) \
            or (self._zeros(n, 6, 6), self._zeros(n, 6))

    def compute_CT_tilde(self, dt, theta):
        """Deviatoric consistent tangent (C_tilde_inv + dt(1-theta)
        G_tilde)^-1, by the pivoted 6x6 inverse, with C_tilde where that is
        singular."""
        mat = self.C_tilde_inv + dt * (1 - theta) * self.G_tilde
        CT, ok = inv6x6(mat)
        self.CT_tilde = torch.where(ok[:, None, None], CT, self.C_tilde)
