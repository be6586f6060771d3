"""The plain reference's heat equation: P1 temperature on the mesh file's
tetrahedra, one backward-Euler step by a dense direct solve, in plain
PyTorch.

It shares no code with the program under test.  One step from T_old to T
at time t:

    ((rho cp / dt) M + K + R) T = (rho cp / dt) M T_old + h T_inf(t) (v)_wall

with M the P1 mass (V (1 + delta_ab) / 20 per tetrahedron), K the
conductivity (k V grad N_a . grad N_b), R the Robin facet mass on the wall
triangles (h A (1 + delta_ab) / 12) and the wall load h T_inf A / 3 per
triangle node; the Dirichlet nodes are held at their ramp's value at t and
lifted out of the other rows.  The element temperature is the mean of the
four vertices (the L2 projection of a P1 field onto constants).

Departures from upstream SafeInCave (FEniCS, examples/thermomechanics):
- the matrix is assembled dense and factorized once per dt (LU), where
  upstream solves a sparse system with PETSc's CG; the program solves it
  with Jacobi CG to a relative residual of 1e-12;
- the ramps are read by linear interpolation at the step's end time,
  clamped at their ends, as the program's boundary conditions read them;
- no Neumann flux: the configurations state none.
"""
from __future__ import annotations

import numpy as np
import torch

from .fem import per_element


class Heat:
    """The configuration's heat equation ("heat", "temperature_K",
    "density", "regions") on ``mesh``, in ``dtype`` on ``device``; ``T``
    (N,) is the nodal temperature after the last step."""

    def __init__(self, mesh, cfg, dtype=torch.float64, device="cpu"):
        self.mesh, self.dtype, self.device = mesh, dtype, torch.device(device)
        spec, rules = cfg["heat"], cfg.get("regions", [])
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa
                                      device=self.device)
        n = mesh.n_nodes
        rho_cp = (per_element(mesh, cfg["density"], rules)
                  * per_element(mesh, spec["specific_heat"], rules))
        k = per_element(mesh, spec["conductivity"], rules)
        self.tets = tets = torch.as_tensor(mesh.tets, device=self.device)
        vol, grad = t(mesh.vol), t(mesh.grad)
        eye4 = torch.eye(4, dtype=dtype, device=self.device)
        Me = (t(rho_cp) * vol / 20.0)[:, None, None] * (1.0 + eye4)
        Ke = (t(k) * vol)[:, None, None] * torch.einsum("ead,ebd->eab",
                                                        grad, grad)
        rows = tets[:, :, None].expand(-1, 4, 4).reshape(-1)
        cols = tets[:, None, :].expand(-1, 4, 4).reshape(-1)
        self.M = self._assemble(n, rows, cols, Me)
        self.K = self._assemble(n, rows, cols, Ke)
        self.R = torch.zeros(n, n, dtype=dtype, device=self.device)
        self.wall_load = torch.zeros(n, dtype=dtype, device=self.device)
        names = mesh.boundary_names()
        wall = spec.get("robin")
        self.robin = None
        if wall and wall["face"] in names:
            idx = mesh.facets(wall["face"])
            tris = torch.as_tensor(mesh.tris[idx], device=self.device)
            hA = wall["h"] * t(mesh.tri_area[idx])
            eye3 = torch.eye(3, dtype=dtype, device=self.device)
            Re = (hA / 12.0)[:, None, None] * (1.0 + eye3)
            self.R = self._assemble(
                n, tris[:, :, None].expand(-1, 3, 3).reshape(-1),
                tris[:, None, :].expand(-1, 3, 3).reshape(-1), Re)
            self.wall_load.index_add_(0, tris.reshape(-1),
                                      (hA / 3.0)[:, None].expand(-1, 3)
                                      .reshape(-1))
            self.robin = (wall["times_s"], wall["values_K"])
        top = spec.get("dirichlet")
        face = next((f for f in (top or {}).get("faces", []) if f in names),
                    None)
        self.fixed = torch.as_tensor(
            np.unique(mesh.tris[mesh.facets(face)]) if face is not None
            else np.zeros(0, np.int64), device=self.device)
        self.ramp = (top["times_s"], top["values_K"]) if face else None
        self.T = torch.full((n,), float(cfg["temperature_K"]), dtype=dtype,
                            device=self.device)
        self._ops = {}

    def _assemble(self, n, rows, cols, local):
        A = torch.zeros(n, n, dtype=self.dtype, device=self.device)
        A.index_put_((rows, cols), local.reshape(-1), accumulate=True)
        return A

    def _operator(self, dt):
        """(the step matrix at ``dt``, the LU factors of its copy with the
        Dirichlet rows and columns replaced by the identity)."""
        if dt not in self._ops:
            A = self.M / dt + self.K + self.R
            held = A.clone()
            held[self.fixed, :] = 0.0
            held[:, self.fixed] = 0.0
            held[self.fixed, self.fixed] = 1.0
            self._ops[dt] = (A, torch.linalg.lu_factor(held))
        return self._ops[dt]

    def step(self, t, dt):
        """One backward-Euler step to time ``t`` (s) of length ``dt``."""
        A, (LU, piv) = self._operator(dt)
        b = (self.M @ self.T) / dt
        if self.robin is not None:
            b = b + float(np.interp(t, *self.robin)) * self.wall_load
        T_bc = torch.zeros_like(self.T)
        if self.ramp is not None:
            T_bc[self.fixed] = float(np.interp(t, *self.ramp))
        rhs = b - A @ T_bc
        rhs[self.fixed] = T_bc[self.fixed]
        self.T = torch.linalg.lu_solve(LU, piv, rhs[:, None])[:, 0]

    def elems(self):
        """The element temperature (E,): the mean of the four vertices."""
        return self.T[self.tets].mean(1)
