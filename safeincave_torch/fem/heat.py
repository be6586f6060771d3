"""Transient heat diffusion: P1 temperature, implicit (backward-Euler) step
(port of safeincave_tpu/fem/heat.py).  One step:

    a(dT, v) = (rho cp / dt)(dT, v) + (k grad dT, grad v) + sum h (dT, v)_G
    L(v)     = (rho cp / dt)(T_old, v) + neumann + sum h T_inf (v)_G

solved matrix-free with Jacobi-preconditioned CG (the operator is SPD) and
Dirichlet conditions by masking and lifting.  Every operator piece is plain
torch ops, as it is plain XLA in the JAX package.  A step returns new
tensors and never writes into ``T`` or ``T_old``, so a snapshot that shares
them (a dt-retry's restore point) stays what it was.

On CUDA the step runs from captured graphs (fem/graphs.py) of the heat
equation's own ``Graphs``, as the JAX package runs it as one jitted
program: its set-up (boundary arrays from the conditions' device tables,
built once, and one interpolated scalar per condition; right-hand side,
lifting, start and Jacobi diagonals) is one ``Graphs`` call, and the CG
blocks of the solve replay through ``Graphs.runner``, their operator
reading bound buffers.  A new material, kernel or set of conditions clears
the graphs.  On the CPU, under ``graphs.eager()`` and for a part kernel of
the parallel layer, the same functions run uncaptured.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from .._device import default_device
from .graphs import Graphs
from .kernels import F32, F64, HeatKernel
from .momentum import SolverSettings
from .solvers import _CG, _ir, _krylov, _vdot, cg_solve


class HeatDiffusion:
    def __init__(self, grid, device=None):
        self.device = torch.device(device) if device else default_device()
        self.grid = grid
        self.graphs = None
        self.kernel = HeatKernel(grid, self.device)
        self.n_elems = grid.n_elems
        self.n_nodes = grid.n_nodes
        self.T = torch.zeros(self.n_nodes, dtype=F64, device=self.device)
        self.T_old = self.T
        self.solver = SolverSettings(method="cg")
        self.solver_stats = (0, 0.0)

    @property
    def kernel(self):
        return self._kernel

    @kernel.setter
    def kernel(self, kern):
        """A new kernel drops the graphs that closed over the old one; a
        part kernel of the parallel layer runs uncaptured."""
        self._kernel = kern
        if self.graphs is not None:
            self.graphs.clear()
        self.graphs = Graphs(self.device, enabled=type(kern) is HeatKernel)

    def _f64(self, x):
        return torch.as_tensor(x, dtype=F64).to(self.device)

    def set_material(self, material):
        self.mat = material
        self.initialize()

    def initialize(self):
        self.graphs.clear()
        self.k = self._f64(self.mat.k)
        self.rho = self._f64(self.mat.density)
        self.cp = self._f64(self.mat.cp)

    def set_solver(self, solver: SolverSettings):
        self.solver = solver

    def set_boundary_conditions(self, bc):
        self.graphs.clear()
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

    def _setup(self, T, T_old, coef, k, vals, tables):
        """What a step solves, from device tensors alone (one captured
        graph on CUDA): the boundary arrays from the scalars ``vals``
        (``BcHandler.values``) and the conditions' ``tables``, then
        ``b_eff``, ``x0``, the Jacobi diagonals, and per precision the
        operator's factors (``HeatKernel.factors``), mask and free
        mask."""
        kern, bc = self.kernel, self.bc
        mask, T_bc, load = bc.step_arrays(vals, tables)
        robin = tables["robin"]
        cv20, kv = kern.factors(coef, k)
        diag = mask * (kern.mass_diagonal(coef) + kern.stiffness_diagonal(k)
                       + bc.robin_diagonal(robin)) + (1.0 - mask)
        diag = torch.where(diag.abs() > 0, diag, torch.ones_like(diag))
        b = kern.mass_apply(coef, T_old) + load
        A_bc = kern.apply(cv20, kv, T_bc) + bc.robin_operator_apply(T_bc,
                                                                     robin)
        mask32 = mask.to(F32)
        return {"b_eff": mask * (b - A_bc) + (1.0 - mask) * T_bc,
                "x0": mask * T + (1.0 - mask) * T_bc,
                F64: (1.0 - mask, cv20, kv, diag),
                F32: (mask32, 1.0 - mask32,
                      *kern.factors(coef.to(F32), k.to(F32)),
                      diag.to(F32))}

    def step(self, T, T_old, t, dt):
        """One implicit heat step from (T, T_old) at time ``t``; returns
        (T_new, CG iterations, residual norm as a float) and changes
        nothing.  Mixed precision by default, like the momentum solve:
        float32 CG under float64 defect correction (fem/solvers.py
        ``ir_solve``); ``precision="f64"`` runs plain float64 CG.  The step
        is a ``heat`` span of :mod:`~safeincave_torch.tracing`.

        On CUDA the set-up is one replay of :meth:`_setup`, which reads
        the conditions' scalars at ``t`` (copied to the card without a
        sync) and their tables built once; ``dt`` enters through the
        ``coef`` tensor alone, so a new ``dt`` captures nothing.  The CG
        blocks replay under the key prefix ``"heat"``, reading the masks,
        operator factors in both precisions, Jacobi diagonals and Robin
        tables from buffers bound to the graphs (``Graphs.bind``) and
        refreshed every step; the operator applications of the solver's
        start, before its first block, replay a graph of the operator.
        The residual is the one the last block's packed read brought back,
        so the caller reads nothing more.

        The Robin facet term is tiny beside the mass term and stays
        float64 inside the float32 operator, or the correction stalls."""
        tracing.begin(tracing.HEAT)
        bc, s, g = self.bc, self.solver, self.graphs
        bind = g.bind
        vals = torch.tensor(bc.values(t), dtype=F64)
        if self.device.type == "cuda":
            vals = vals.pin_memory().to(self.device, non_blocking=True)
        tables = bc.tables()
        coef = self.rho * self.cp / dt
        out = g(("heat.setup",), self._setup, T, T_old, coef, self.k, vals,
                tables)
        # what the CG blocks read, per precision: mask, free mask,
        # operator factors, Jacobi diagonal, in buffers that outlive a step
        names = ("mask", "free", "cv20", "kv", "diag")
        ops = {dtype: tuple(bind(f"heat.{n}", x) for n, x in zip(names, xs))
               for dtype, xs in ((F64, (tables["mask"], *out[F64])),
                                 (F32, out[F32]))}
        robin = [tuple(bind(f"heat.robin{i}.{j}", x) if j < 3 else x
                       for j, x in enumerate(r))
                 for i, r in enumerate(tables["robin"])]
        kern = self.kernel
        in_block = []
        heat_run = g.runner("heat")

        def run(tag, block, state):
            in_block.append(tag)
            try:
                return heat_run(tag, block, state)
            finally:
                in_block.pop()

        def A(x):
            m, free, cv20, kv, _ = ops[x.dtype]
            y = m * x
            Ay = (kern.apply(cv20, kv, y)
                  + bc.robin_operator_apply(y.to(F64), robin).to(x.dtype))
            return m * Ay + free * x

        def Aop(x):
            # a block's applications are captured with it; the solver's
            # start, before its first block, replays one graph each
            return A(x) if in_block else g(("heat.A",), A, x)

        def M_inv(r):
            return r / ops[r.dtype][4]

        if s.precision == "mixed":
            x, iters, _, res, _ = _ir(
                Aop, Aop, out["b_eff"], out["x0"], M_inv, cg_solve, s.rtol,
                0.0, s.inner_rtol, s.max_it, s.max_passes, _vdot, run)
        else:
            x, iters, _, res = _krylov(_CG, Aop, out["b_eff"], out["x0"],
                                       M_inv, s.rtol, 0.0, s.max_it, _vdot,
                                       run)
        tracing.end(tracing.HEAT)
        return x, iters, res

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
