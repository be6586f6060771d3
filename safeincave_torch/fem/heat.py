"""Transient heat diffusion: P1 temperature, implicit (backward-Euler) step
(port of safeincave_tpu/fem/heat.py).  One step:

    a(dT, v) = (rho cp / dt)(dT, v) + (k grad dT, grad v) + sum h (dT, v)_G
    L(v)     = (rho cp / dt)(T_old, v) + neumann + sum h T_inf (v)_G

solved matrix-free with Jacobi-preconditioned CG (the operator is SPD) and
Dirichlet conditions by masking and lifting.  Every operator piece is plain
torch ops, as it is plain XLA in the JAX package.  A step returns new
tensors and never writes into ``T`` or ``T_old``, so a snapshot that shares
them (a dt-retry's restore point) stays what it was.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import default_device
from .kernels import F64, HeatKernel
from .momentum import SolverSettings
from .solvers import cg_solve, ir_solve


class HeatDiffusion:
    def __init__(self, grid, device=None):
        self.device = torch.device(device) if device else default_device()
        self.grid = grid
        self.kernel = HeatKernel(grid, self.device)
        self.n_elems = grid.n_elems
        self.n_nodes = grid.n_nodes
        self.T = torch.zeros(self.n_nodes, dtype=F64, device=self.device)
        self.T_old = self.T
        self.solver = SolverSettings(method="cg")
        self.solver_stats = (0, 0.0)

    def _f64(self, x):
        return torch.as_tensor(x, dtype=F64).to(self.device)

    def set_material(self, material):
        self.mat = material
        self.initialize()

    def initialize(self):
        self.k = self._f64(self.mat.k)
        self.rho = self._f64(self.mat.density)
        self.cp = self._f64(self.mat.cp)

    def set_solver(self, solver: SolverSettings):
        self.solver = solver

    def set_boundary_conditions(self, bc):
        self.bc = bc

    def set_initial_T(self, T_field):
        T = self._f64(T_field)
        if T.dim() == 0:
            T = T.expand(self.n_nodes).clone()
        self.T = T
        self.T_old = T

    def update_T_old(self):
        self.T_old = self.T

    def get_T_elems(self):
        """Nodal T averaged onto the elements (DG0)."""
        return self.kernel.nodes_to_elems(self.T)

    def step(self, T, T_old, t, dt):
        """One implicit heat step from (T, T_old) at time ``t``; returns
        (T_new, CG iterations, residual norm) and changes nothing.

        Mixed precision by default, like the momentum solve: float32 CG
        under float64 defect correction (fem/solvers.py ``ir_solve``).  The
        Robin facet term is tiny beside the mass term and stays float64
        inside the float32 operator, or the correction stalls.
        ``precision="f64"`` runs plain float64 CG."""
        kern, bc, s = self.kernel, self.bc, self.solver
        mask, T_bc = bc.dirichlet_arrays(t)
        coef = self.rho * self.cp / dt
        k = self.k
        # per-dtype copies made once per step, not once per CG iteration
        masks = {F64: mask, torch.float32: mask.to(torch.float32)}
        coefs = {F64: (coef, k), torch.float32: (coef.to(torch.float32),
                                                 k.to(torch.float32))}

        def A_full(x):
            c, kk = coefs[x.dtype]
            robin = bc.robin_operator_apply(x.to(F64)).to(x.dtype)
            return kern.mass_apply(c, x) + kern.stiffness_apply(kk, x) + robin

        def Aop(x):
            m = masks[x.dtype]
            return m * A_full(m * x) + (1.0 - m) * x

        diag = mask * (kern.mass_diagonal(coef) + kern.stiffness_diagonal(k)
                       + bc.robin_diagonal()) + (1.0 - mask)
        diag = torch.where(diag.abs() > 0, diag, torch.ones_like(diag))
        diags = {F64: diag, torch.float32: diag.to(torch.float32)}

        def M_inv(r):
            return r / diags[r.dtype]

        b = kern.mass_apply(coef, T_old) + bc.neumann_rhs(t) + bc.robin_rhs(t)
        b_eff = mask * (b - A_full(T_bc)) + (1.0 - mask) * T_bc
        x0 = mask * T + (1.0 - mask) * T_bc
        if s.precision == "mixed":
            return ir_solve(Aop, Aop, b_eff, x0, M_inv, inner_solve=cg_solve,
                            rtol=s.rtol, inner_rtol=s.inner_rtol,
                            inner_maxiter=s.max_it, max_passes=s.max_passes)
        return cg_solve(Aop, b_eff, x0, M_inv, rtol=s.rtol, maxiter=s.max_it)

    def solve(self, t, dt):
        """Assemble and solve one implicit step; T and T_old both become
        the new field."""
        x, iters, res = self.step(self.T, self.T_old, t, dt)
        self.solver_stats = (int(iters), float(res))
        self.T = x
        self.update_T_old()

    def solve_steps(self, ts, dts):
        """Advance ``len(ts)`` implicit heat steps; returns the (K, 2) rows
        ``[cg_iters, residual]``."""
        rows = []
        for t, dt in zip(ts, dts):
            self.solve(t, dt)
            rows.append([float(self.solver_stats[0]), self.solver_stats[1]])
        return np.asarray(rows, dtype=np.float64).reshape(-1, 2)
