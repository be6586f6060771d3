"""Momentum boundary conditions (port of safeincave_tpu/bcs/momentum_bc.py).

Dirichlet BCs become per-component node masks + value arrays (matrix-free
symmetric elimination); Neumann BCs, with the hydrostatic column
``-p(t) + rho g (H - x_i)``, are assembled exactly over boundary triangles
with the linear-integrand rule ``int f N_a dA = A/12 (2 f_a + f_b + f_c)``.
Both are built on the host in float64 at each requested time and moved to
the equation's device.
"""
from __future__ import annotations

import numpy as np
import torch


def interp(t: float, xp: np.ndarray, fp: np.ndarray) -> float:
    """Scalar linear interpolation with constant end clamping, in the same
    operation order as ``jnp.interp``."""
    t = float(t)
    i = int(np.clip(np.searchsorted(xp, t, side="right"), 1, len(xp) - 1))
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = t - xp[i - 1]
    if abs(dx) <= np.spacing(np.finfo(np.float64).eps):
        f = fp[i - 1]
    else:
        f = fp[i - 1] + (delta / dx) * df
    if t < xp[0]:
        f = fp[0]
    if t > xp[-1]:
        f = fp[-1]
    return float(f)


class GeneralBC:
    def __init__(self):
        self.boundary_name = None
        self.type = None
        self.values = None
        self.time_values = None


class DirichletBC(GeneralBC):
    """Time-dependent essential BC on one displacement component."""

    def __init__(self, boundary_name: str, component: int, values,
                 time_values):
        self.boundary_name = boundary_name
        self.type = "dirichlet"
        self.values = np.asarray(values, dtype=np.float64)
        self.time_values = np.asarray(time_values, dtype=np.float64)
        self.component = component


class NeumannBC(GeneralBC):
    """Traction/pressure BC with a hydrostatic column."""

    def __init__(self, boundary_name: str, direction: int, density: float,
                 ref_pos: float, values, time_values, g: float = -9.81):
        self.boundary_name = boundary_name
        self.type = "neumann"
        self.values = np.asarray(values, dtype=np.float64)
        self.time_values = np.asarray(time_values, dtype=np.float64)
        self.direction = direction
        self.density = density
        self.ref_pos = ref_pos
        self.gravity = g


class BcHandler:
    """Organizes BCs and produces mask/value/RHS tensors at a given time."""

    def __init__(self, equation):
        self.eq = equation
        self.grid = equation.grid
        self.device = equation.device
        self.reset_boundary_conditions()

    def reset_boundary_conditions(self):
        self.dirichlet_boundaries = []
        self.neumann_boundaries = []
        self._dirichlet_meta = []   # (node_indices, component, times, values)
        self._neumann_meta = []

    def add_boundary_condition(self, bc: GeneralBC):
        grid = self.grid
        if bc.type == "dirichlet":
            self.dirichlet_boundaries.append(bc)
            facets = grid.get_boundary_tags(bc.boundary_name)
            nodes = np.unique(grid.tris[facets].reshape(-1))
            self._dirichlet_meta.append((nodes, bc.component,
                                         bc.time_values, bc.values))
        elif bc.type == "neumann":
            self.neumann_boundaries.append(bc)
            facets = np.asarray(grid.get_boundary_tags(bc.boundary_name))
            tris = grid.tris[facets]                       # (F, 3)
            self._neumann_meta.append(dict(
                tris=tris, areas=grid.tri_areas[facets],
                normals=grid.tri_normals[facets],
                coords=grid.points[tris],                  # (F, 3, 3)
                direction=bc.direction, density=bc.density,
                ref_pos=bc.ref_pos, gravity=bc.gravity,
                times=bc.time_values, values=bc.values))
        else:
            raise ValueError(f"Boundary type {bc.type} not supported.")

    @property
    def all_zero_dirichlet(self) -> bool:
        """Every Dirichlet schedule is identically zero, so the solver may
        skip the lifting matvec A @ u_bc."""
        return all(np.all(bc.values == 0.0)
                   for bc in self.dirichlet_boundaries)

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device)

    def dirichlet_arrays(self, t):
        """(mask, u_bc): mask is 1 on free dofs and 0 on constrained ones;
        u_bc holds the prescribed values.  Later BCs overwrite earlier ones
        on shared nodes."""
        n = self.grid.n_nodes
        mask = np.ones((n, 3))
        u_bc = np.zeros((n, 3))
        for nodes, comp, times, values in self._dirichlet_meta:
            mask[nodes, comp] = 0.0
            u_bc[nodes, comp] = interp(t, times, values)
        return self._tensor(mask), self._tensor(u_bc)

    def neumann_rhs(self, t):
        """Assembled surface-traction RHS (n_nodes, 3) at time t."""
        f = np.zeros((self.grid.n_nodes, 3))
        for m in self._neumann_meta:
            p = -interp(t, m["times"], m["values"])
            x_i = m["coords"][:, :, m["direction"]]        # (F, 3)
            v = p + m["density"] * m["gravity"] * (m["ref_pos"] - x_i)
            w = (m["areas"] / 12.0)[:, None] * (2.0 * v + np.roll(v, 1, axis=1)
                                                + np.roll(v, 2, axis=1))
            contrib = w[:, :, None] * m["normals"][:, None, :]  # (F, 3, 3)
            seg = np.zeros_like(f)
            np.add.at(seg, m["tris"].reshape(-1), contrib.reshape(-1, 3))
            f = f + seg
        return self._tensor(f)

    def update_dirichlet(self, t):
        self.mask, self.u_bc = self.dirichlet_arrays(t)

    def update_neumann(self, t):
        self.b_neumann = self.neumann_rhs(t)
