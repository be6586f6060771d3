"""Composite material container (port of safeincave_tpu/materials/material.py).

Aggregates the elastic stiffness and the inelastic G/B operators, and builds
the consistent tangent CT = (C_inv + dt(1-theta) G)^-1 with the reference's
per-element elastic fallback on singular tangents.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import default_device
from ..linalg import inv6x6_fast


class Material:
    def __init__(self, n_elems: int, device=None):
        self.n_elems = n_elems
        self.device = torch.device(device) if device else default_device()
        self.elems_ne = []
        self.elems_e = []
        self._C = np.zeros((n_elems, 6, 6))
        self._C_inv = np.zeros((n_elems, 6, 6))
        self._set_elastic()

    def _set_elastic(self):
        self.C = torch.as_tensor(self._C, device=self.device)
        self.C_inv = torch.as_tensor(self._C_inv, device=self.device)
        # inv(C_inv) on the host: the singular-tangent fallback
        self._CT_el = torch.as_tensor(np.linalg.inv(self._C_inv)
                                      if self.elems_e else self._C,
                                      device=self.device)
        # float32 shadows for the f32 fixed-point sweep
        self._f32 = (self.C_inv.to(torch.float32),
                     self._CT_el.to(torch.float32))

    def set_density(self, density):
        self.density = np.asarray(density, dtype=np.float64)

    def add_to_elastic(self, elem):
        elem.initialize()
        self._C = self._C + elem.C
        self._C_inv = self._C_inv + elem.C_inv
        self.elems_e.append(elem)
        self._set_elastic()
        self.K = elem.K
        self.E = elem.E
        self.ShearMod = 3 * self.K * self.E / (9 * self.K - self.E)

    def add_to_non_elastic(self, elem):
        self.elems_ne.append(elem)

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
