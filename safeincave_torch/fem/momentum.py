"""Linear momentum equation: matrix-free theta-scheme inelastic solver.

Port of ``safeincave_tpu/fem/momentum.py`` (the always-fresh, always-tight
float64 fixed point that the cavern benchmark runs).  One linearized step:

    CT  = (C_inv + dt(1-theta) G)^-1                       (consistent tangent)
    eps_rhs = eps_ne_k - dt(1-theta)(B + G:sigma_k)
    a(du, v) = <CT eps(du), eps(v)>          (matrix-free stiffness action)
    L(v)     = body + neumann + <CT eps_rhs, eps(v)>
    solve by preconditioned Krylov with Dirichlet masking/lifting

The JAX package runs a time step as one jitted ``lax.while_loop``; here the
fixed-point and Krylov loops are Python loops that read their conditions on
the host, with the same update sequence.

Not ported yet (queued in ROADMAP.md): the float32 fixed-point phase, tangent
lagging, adaptive inner tolerances, halo mode and thermal coupling.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .._device import default_device
from ..linalg import inv3x3
from ..materials.base import _as_voigt, apply66
from ..utils import voigt_to_tensor, voigt_weight
from .kernels import F32, F64, MomentumKernel
from .solvers import bicgstab_solve, cg_solve, ir_solve


@dataclass
class SolverSettings:
    """Krylov settings.

    ``precision="mixed"`` runs the Krylov iterations in f32 under an f64
    defect-correction loop (fem/solvers.py:ir_solve); convergence is still
    the f64 relative residual ``rtol``.  ``precision="f64"`` runs everything
    in f64.

    ``precond``: "dense" is the dense f32 inverse of the masked elastic
    operator, built once per wiring and applied as one gemv per Krylov
    iteration ((3 n_nodes)^2 f32 of device memory, gated by
    ``dense_max_dofs``); "2level" is block-Jacobi plus a dense coarse
    correction over ``coarse_agg`` consecutive nodes; "jacobi" is nodal
    3x3 blocks.  "auto" picks dense on CUDA below the gate and 2level
    otherwise, as the JAX package does on an accelerator and on the CPU.

    Every method other than "cg" runs BiCGStab, as in the JAX package.
    """
    method: str = "bicgstab"
    rtol: float = 1e-12
    max_it: int = 2000          # per-pass Krylov iteration cap
    precision: str = "mixed"    # "mixed" | "f64"
    inner_rtol: float = 1e-4    # f32 pass target, above the f32 noise floor
    max_passes: int = 12        # defect-correction passes (mixed only)
    precond: str = "auto"       # "auto" | "dense" | "2level" | "jacobi"
    dense_max_dofs: int = 30_000
    coarse_agg: int = 16        # nodes per coarse aggregate
    adaptive_rtol: bool = False
    lag_tangent: bool = False
    fp32_phase: object = "auto"

    def __post_init__(self):
        for name in ("adaptive_rtol", "lag_tangent"):
            if getattr(self, name):
                raise NotImplementedError(
                    f"{name}=True is not ported yet (queued in ROADMAP.md)")
        if self.fp32_phase not in ("auto", False):
            raise NotImplementedError(
                "fp32_phase=True is not ported yet (queued in ROADMAP.md)")

    def fp32_enabled(self) -> bool:
        """The f32 fixed-point phase is not ported: "auto" resolves to
        False."""
        return False

    def solve_fn(self):
        return cg_solve if self.method == "cg" else bicgstab_solve


# --------------------------------------------------------------------------- #
# Preconditioners: assembled on the host in f64, inverted and applied on the
# equation's device.  Host assembly is deterministic (sequential sums), so the
# preconditioner's bits, and with them the Krylov counts, repeat run to run.
# --------------------------------------------------------------------------- #
def _block_jacobi_arrays(kern, C, mask):
    """Masked nodal 3x3 block inverses (N, 3, 3) f64 on the device."""
    blk = kern.block_diagonal(C)
    blk = blk * mask[:, :, None] * mask[:, None, :]
    blk = blk + (1.0 - mask)[:, :, None] * np.eye(3)[None]
    return inv3x3(torch.as_tensor(blk, device=kern.device))


def _blk_apply(inv, r):
    """(N, 3, 3) block apply."""
    inv_t = inv.permute(1, 2, 0).to(r.dtype)                      # (3, 3, N)
    return (inv_t * r.T[None]).sum(1).T


def _coarse_space(kern, C, mask, G):
    """Dense coarse operator over aggregates of G consecutive node ids,
    from the per-element stiffness with Dirichlet rows/cols masked, inverted
    in f32 after scaling to O(1), diagonal regularization and
    symmetrization (an unsymmetrized f32 inverse can turn the
    preconditioner indefinite).  Returns (coarse_inv, n_agg, pad)."""
    n_nodes = kern.n_nodes
    n_agg = -(-n_nodes // G)
    pad = n_agg * G - n_nodes
    conn = kern.conn_np
    Ke = kern.element_stiffness(C)
    mrows = mask[conn]                                            # (E,4,3)
    Ke = Ke * mrows[:, :, :, None, None] * mrows[:, None, None, :, :]
    agg = conn // G
    pair = agg[:, :, None] * n_agg + agg[:, None, :]              # (E,4,4)
    flat = np.transpose(Ke, (0, 1, 3, 2, 4)).reshape(-1, 3, 3)
    Ac = np.zeros((n_agg * n_agg, 3, 3))
    np.add.at(Ac, pair.reshape(-1), flat)
    Ac = Ac.reshape(n_agg, n_agg, 3, 3).transpose(0, 2, 1, 3)
    Ac = torch.as_tensor(Ac.reshape(3 * n_agg, 3 * n_agg).astype(np.float32),
                         device=kern.device)
    scale = torch.clamp(torch.diagonal(Ac).abs().max(), min=1e-30)
    Acs = Ac / scale + 1e-6 * torch.eye(Ac.shape[0], dtype=F32,
                                        device=kern.device)
    inv = torch.linalg.inv(Acs)
    return 0.5 * (inv + inv.T) / scale, n_agg, pad


def _two_level_apply(blk_inv, coarse_inv, mask, r, n_agg, G, pad):
    """Additive two-level preconditioner: block-Jacobi + coarse correction."""
    z = _blk_apply(blk_inv, r)
    rp = torch.nn.functional.pad(r * mask, (0, 0, 0, pad))
    rc = rp.reshape(n_agg, G, 3).sum(1).to(F32)
    zc = (coarse_inv @ rc.reshape(-1)).reshape(n_agg, 3)
    zf = zc.repeat_interleave(G, dim=0)[:r.shape[0]].to(r.dtype)
    return z + zf * mask


def _dense_inverse_precond(kern, C, mask):
    """Dense f32 inverse of the masked elastic operator, (3N, 3N).

    The element blocks are summed on the host in f64 by a coalescing sparse
    assembly (deterministic), cast to f32, then masked, scaled and inverted
    with ``torch.linalg.inv`` on the device."""
    from scipy.sparse import coo_matrix
    n3 = 3 * kern.n_nodes
    Ke = kern.element_stiffness(C)
    dof = 3 * kern.conn_np[:, :, None] + np.arange(3)[None, None, :]
    rows = np.repeat(dof.reshape(-1, 12), 12, axis=1).reshape(-1)
    cols = np.tile(dof.reshape(-1, 12), (1, 12)).reshape(-1)
    A = coo_matrix((Ke.reshape(-1), (rows, cols)), shape=(n3, n3)).toarray()
    A = torch.as_tensor(A.astype(np.float32), device=kern.device)
    m = torch.as_tensor(mask.reshape(-1), dtype=F32, device=kern.device)
    A = A * m[:, None] * m[None, :]
    scale = torch.diagonal(A).abs().max()
    A = A / scale + torch.diag(1.0 - m)
    return torch.linalg.inv(A) / scale


def build_preconditioner(kern, C, mask, settings: SolverSettings):
    """(P, apply) for the masked operator, built once per wiring from the
    constant elastic stiffness ``C`` and the Dirichlet ``mask``;
    ``apply(P, r, mask)`` works in r's dtype."""
    C = C.cpu().numpy() if isinstance(C, torch.Tensor) else np.asarray(C)
    mask = (mask.cpu().numpy() if isinstance(mask, torch.Tensor)
            else np.asarray(mask))
    mode = settings.precond
    if mode == "auto":
        mode = ("dense" if kern.device.type == "cuda"
                and 3 * kern.n_nodes <= settings.dense_max_dofs else "2level")

    if mode == "dense":
        inv = _dense_inverse_precond(kern, C, mask)

        def apply_dense(P, r, m):
            (inv,) = P
            x = torch.mv(inv, r.reshape(-1).to(inv.dtype))
            return x.reshape(-1, 3).to(r.dtype)

        return (inv,), apply_dense

    blk_inv = _block_jacobi_arrays(kern, C, mask)
    if mode == "2level":
        G = settings.coarse_agg
        coarse_inv, n_agg, pad = _coarse_space(kern, C, mask, G)

        def apply_2l(P, r, m):
            blk_inv, coarse_inv = P
            return _two_level_apply(blk_inv, coarse_inv, m.to(r.dtype), r,
                                    n_agg, G, pad)

        return (blk_inv, coarse_inv), apply_2l
    if mode != "jacobi":
        raise ValueError(f"unknown preconditioner {settings.precond!r}")

    def apply_bj(P, r, m):
        (blk_inv,) = P
        return _blk_apply(blk_inv, r)

    return (blk_inv,), apply_bj


def _make_masked_solver(kern, settings: SolverSettings, apply_M,
                        zero_dirichlet: bool = False):
    """Build ``solve_lin(CT, b, mask, u_bc, x0, rtol, P) -> (x, iters, res,
    b_eff_norm)``.

    Dirichlet conditions by masking + lifting; ``b_eff_norm`` is the norm
    of the right-hand side actually solved.  The f64 action is the cumsum
    matvec; in mixed precision the f32 Krylov operator is the band kernel
    when the kernel has one, else the f32 cumsum matvec.  When the mixed
    passes stagnate above the target, the solve finishes in f64 from the
    best mixed iterate and keeps whichever residual is smaller.
    ``zero_dirichlet`` drops the lifting matvec A @ u_bc, which is zero for
    homogeneous supports.
    """
    solve = settings.solve_fn()
    mixed = settings.precision == "mixed"

    def solve_lin(CT, b, mask, u_bc, x0, rtol, P):
        CT_hi = kern.prep(CT)
        free = 1.0 - mask

        def Aop(x):
            return mask * kern.matvec(CT_hi, mask * x) + free * x

        def M_inv(r):
            return apply_M(P, r, mask)

        if zero_dirichlet:
            b_eff = mask * b
        else:
            b_eff = mask * (b - kern.matvec(CT_hi, u_bc)) + free * u_bc
        b_eff_norm = torch.sqrt(torch.dot(b_eff.reshape(-1),
                                          b_eff.reshape(-1)))
        if not mixed:
            x, k, res = solve(Aop, b_eff, x0, M_inv, rtol=rtol,
                              maxiter=settings.max_it)
            return x, k, res, b_eff_norm

        mask32 = mask.to(F32)
        free32 = 1.0 - mask32
        CT_lo = kern.prep(CT.to(F32))
        if kern.band is not None:
            ctv = kern.band.pack_ct(CT_lo)

            def Aop32(x):
                return mask32 * kern.band.matvec(ctv, mask32 * x) + free32 * x
        else:
            def Aop32(x):
                return mask32 * kern.matvec(CT_lo, mask32 * x) + free32 * x

        def M_inv32(r):
            return apply_M(P, r, mask32)

        x, k, res = ir_solve(Aop, Aop32, b_eff, x0, M_inv32,
                             inner_solve=solve, rtol=rtol,
                             inner_rtol=settings.inner_rtol,
                             inner_maxiter=settings.max_it,
                             max_passes=settings.max_passes)
        if float(res) > rtol * float(b_eff_norm):
            x2, k2, res2 = solve(Aop, b_eff, x, M_inv, rtol=rtol,
                                 maxiter=settings.max_it)
            k += k2
            if math.isfinite(float(res2)) and float(res2) < float(res):
                x, res = x2, res2
        return x, k, res, b_eff_norm

    return solve_lin


class LinearMomentumBase:
    """Common fields and internal-variable orchestration."""

    def __init__(self, grid, theta: float, device=None):
        self.device = torch.device(device) if device else default_device()
        self.grid = grid
        self.theta = theta
        self.kernel = MomentumKernel(grid, self.device)
        self.n_elems = grid.n_elems
        self.n_nodes = grid.n_nodes
        z = lambda *s: torch.zeros(s, dtype=F64, device=self.device)  # noqa
        self.T0 = z(self.n_elems)
        self.Temp = z(self.n_elems)
        self.u = z(self.n_nodes, 3)
        self.sig_v = z(self.n_elems, 6)
        self.eps_tot_v = z(self.n_elems, 6)
        self.b_body = z(self.n_nodes, 3)
        self.solver = SolverSettings()
        self.solver_stats = (0, 0.0)
        self.krylov_total = 0

    def _f64(self, x):
        return torch.as_tensor(x, dtype=F64).to(self.device)

    # -- wiring ------------------------------------------------------------ #
    def set_material(self, material):
        self.mat = material
        self.C = material.C

    def set_T(self, T):
        self.Temp = self._f64(T)

    def set_T0(self, T0):
        self.T0 = self._f64(T0)

    def set_solver(self, solver: SolverSettings):
        self.solver = solver

    def set_boundary_conditions(self, bc):
        self.bc = bc

    def build_body_force(self, g: list):
        self.g_vec = list(g)
        self.b_body = self.kernel.body_force(self.mat.density, g)

    # -- strain / internal-variable orchestration -------------------------- #
    def compute_total_strain(self):
        self.eps_tot_v = self.kernel.strain(self.u)
        return self.eps_tot_v

    def compute_eps_ne_rate(self, stress, dt):
        sv = self._f64(_as_voigt(stress))
        for e in self.mat.elems_ne:
            e.state = e.f_rate(e.state, sv, dt * self.theta, self.Temp)

    def update_eps_ne_rate_old(self):
        for e in self.mat.elems_ne:
            e.update_eps_ne_rate_old()

    def update_eps_ne_old(self, stress, stress_k, dt):
        sv = self._f64(_as_voigt(stress))
        sv_k = self._f64(_as_voigt(stress_k))
        for e in self.mat.elems_ne:
            e.state = e.f_update_eps_old(e.state, sv, sv_k,
                                         dt * (1 - self.theta))

    def update_internal_variables(self):
        for e in self.mat.elems_ne:
            e.state = e.f_commit_isv(e.state)

    def run_after_solve(self):
        """User extension hook."""

    @property
    def sig(self):
        return voigt_to_tensor(self.sig_v)

    @property
    def eps_tot(self):
        return voigt_to_tensor(self.eps_tot_v)


class LinearMomentum(LinearMomentumBase):
    """Concrete formulation.

    On CUDA a band-ordered grid (``reorder="band"``) selects the hand-written
    band kernel as the f32 Krylov operator, as the JAX package selects its
    Pallas band kernel on an accelerator; the f64 defect correction keeps the
    cumsum matvec.  A plan or build failure raises.
    """

    def __init__(self, grid, theta: float, auto_backend: bool = True,
                 device=None):
        super().__init__(grid, theta, device)
        self._precond = None
        self._solve_lin = None
        if (auto_backend and self.device.type == "cuda"
                and getattr(grid, "reorder_method", None) == "band"):
            self.kernel.enable_band()

    def enable_band_matvec(self):
        """Route the f32 Krylov stiffness action through the band kernel
        (on the CPU its plain twin)."""
        self.kernel.enable_band()
        self._solve_lin = None

    def set_solver(self, solver):
        super().set_solver(solver)
        self._precond = None
        self._solve_lin = None

    def set_boundary_conditions(self, bc):
        super().set_boundary_conditions(bc)
        self._precond = None
        self._solve_lin = None

    def compute_elastic_stress(self, eps_e):
        self.sig_v = apply66(self.mat.C, self._f64(_as_voigt(eps_e)))
        return self.sig_v

    # ------------------------------------------------------------------ #
    def _get_precond(self):
        """(P, apply), built once per wiring from C and the Dirichlet mask."""
        if self._precond is None:
            if not hasattr(self.bc, "mask"):
                self.bc.update_dirichlet(0.0)
            self._precond = build_preconditioner(
                self.kernel, self.mat.C, self.bc.mask, self.solver)
        return self._precond

    def _get_solver(self):
        if self._solve_lin is None:
            _, apply_M = self._get_precond()
            self._solve_lin = _make_masked_solver(
                self.kernel, self.solver, apply_M,
                zero_dirichlet=self.bc.all_zero_dirichlet)
        return self._solve_lin

    def _linear_solve(self, CT, b):
        """Solve a(CT) u = b with Dirichlet masking + lifting."""
        mask, u_bc = self.bc.mask, self.bc.u_bc
        x0 = mask * self.u + (1.0 - mask) * u_bc
        P, _ = self._get_precond()
        x, iters, res, _ = self._get_solver()(CT, b, mask, u_bc, x0,
                                              self.solver.rtol, P)
        self.solver_stats = (iters, float(res))
        return x

    def solve_elastic_response(self):
        """Purely elastic boundary value problem."""
        b = self.b_body + self.bc.b_neumann
        self.u = self._linear_solve(self.mat.C, b)
        self.run_after_solve()

    # ------------------------------------------------------------------ #
    def _fixed_point(self, states, sv, eps_v, u, b_ext, mask, u_bc, dt, tol,
                     maxiter):
        """One time step's fixed-point iteration: tangent -> CT -> eps_rhs
        -> Krylov -> strain -> stress -> ISV increment -> rates ->
        strain-change error, until ``err <= tol`` (after at least one
        iteration), ``maxiter``, or a non-finite error.

        A diverged or stalled solve, or a non-finite stress, sets the error
        to inf so the step fails instead of reading as converged.

        Returns (states, sv, eps_v, u, sv_k, iterations, err,
        (krylov_total, krylov_last, lin_res))."""
        mat, kern, theta = self.mat, self.kernel, self.theta
        elems_ne = list(mat.elems_ne)
        trivial_error = theta == 1.0 or not elems_ne
        rtol = self.solver.rtol
        P, _ = self._get_precond()
        solve_lin = self._get_solver()
        w = voigt_weight(sv)
        free = 1.0 - mask
        phi1, phi2 = dt * theta, dt * (1 - theta)

        ite, err, sv_k = 0, 1.0, sv
        kry_tot, kry, lin_res = 0, 0, 0.0
        while (err > tol and ite < maxiter and math.isfinite(err)) or \
                ite == 0:
            sv_k = sv
            new_states, G, B6 = mat.f_tangent_all(states, sv_k, self.Temp,
                                                  dt, theta)
            G_p = kern.prep(G)
            CT = kern.prep(mat.f_CT(G, dt, theta))
            eps_ne_k = torch.zeros_like(sv)
            states2 = []
            for e, st in zip(elems_ne, new_states):
                st = e.f_eps_k(st, phi1, phi2)
                eps_ne_k = eps_ne_k + st["eps_k"]
                states2.append(st)
            G_sk = kern.apply66(G_p, sv_k)
            eps_rhs = eps_ne_k - phi2 * (B6 + G_sk)
            b = b_ext + kern.internal_force(kern.apply66(CT, eps_rhs))
            x0 = mask * u + free * u_bc
            u_new, kry, res_t, bnorm_t = solve_lin(CT, b, mask, u_bc, x0,
                                                   rtol, P)
            lin_res, lin_bnorm = float(res_t), float(bnorm_t)
            # solve acceptance: a diverged solve, or one stalled more than 4
            # decades above rtol, fails the step (err=inf -> dt-retry)
            rel_res = lin_res / (lin_bnorm + 1e-300)
            solve_ok = (math.isfinite(lin_res)
                        and lin_res <= 10.0 * lin_bnorm + 1e-30
                        and rel_res <= 1e4 * rtol
                        and math.isfinite(float(torch.dot(
                            u_new.reshape(-1), u_new.reshape(-1)))))
            eps_new = kern.strain(u_new)
            sv_new = kern.apply66(CT, eps_new - eps_rhs)
            states3 = []
            for e, st in zip(elems_ne, states2):
                st = e.f_increment_isv(st, sv_new, sv_k, dt)
                st = e.f_rate(st, sv_new, phi1, self.Temp)
                states3.append(st)
            if trivial_error:
                err = 0.0
            else:
                diff = torch.sqrt((((eps_new - eps_v) ** 2) * w).sum())
                ref = torch.sqrt(((eps_new ** 2) * w).sum())
                err = float(diff / ref)
            if not (solve_ok and bool(torch.isfinite(sv_new).all())):
                err = math.inf
            kry_tot += kry
            states, sv, eps_v, u = states3, sv_new, eps_new, u_new
            ite += 1
        return states, sv, eps_v, u, sv_k, ite, err, (kry_tot, kry, lin_res)

    def _commit(self, states, sv, sv_k, dt):
        out = []
        for e, st in zip(self.mat.elems_ne, states):
            st = e.f_commit_isv(st)
            st = e.f_rate_to_old(st)
            st = e.f_update_eps_old(st, sv, sv_k, dt * (1 - self.theta))
            out.append(st)
        return out

    def commit_time_step(self, dt, stress=None, stress_k=None):
        """Commit a converged step: ISV commit, rate_old rollover and the
        inelastic-strain corrector."""
        sv = self.sig_v if stress is None else self._f64(_as_voigt(stress))
        sv_k = (getattr(self, "_last_sv_k", sv) if stress_k is None
                else self._f64(_as_voigt(stress_k)))
        states = self._commit([e.state for e in self.mat.elems_ne], sv,
                              sv_k, dt)
        for e, st in zip(self.mat.elems_ne, states):
            e.state = st

    def _step_inputs(self, t):
        mask, u_bc = self.bc.dirichlet_arrays(t)
        return self.b_body + self.bc.neumann_rhs(t), mask, u_bc

    def solve_time_step(self, t, dt, tol=1e-8, maxiter=40):
        """Run one time step's fixed-point iteration; returns (iterations,
        error).  The Krylov initial guess extrapolates linearly from the
        previous step.  The last iteration's sigma_k is kept for the commit
        phase."""
        u_prev = getattr(self, "_u_last_step", None)
        u0 = self.u if u_prev is None else self.u + (self.u - u_prev)
        self._u_last_step = self.u
        (states, sv, eps_v, u, sv_k, ite, err, stats) = self._fixed_point(
            [e.state for e in self.mat.elems_ne], self.sig_v, self.eps_tot_v,
            u0, *self._step_inputs(t), dt, tol, maxiter)
        for e, st in zip(self.mat.elems_ne, states):
            e.state = st
        self.sig_v, self.eps_tot_v, self.u = sv, eps_v, u
        self._last_sv_k = sv_k
        self.krylov_total = stats[0]
        self.solver_stats = (stats[1], stats[2])
        self.run_after_solve()
        return ite, err

    def solve_time_steps(self, ts, dts, tol=1e-8, maxiter=40):
        """Advance up to ``len(ts)`` time steps, committing each step iff it
        converged.  On the first non-converged step the equation is left at
        that step's entry state (the dt-retry restore point) and the
        remaining steps are skipped.

        Returns a (K, 6) float array of rows ``[iterations, error,
        krylov_total, krylov_last, lin_res, converged]``; rows after the
        first ``converged == 0`` are ``[0, 1, 0, 0, 0, 0]``."""
        states = [e.state for e in self.mat.elems_ne]
        sv, eps_v, u = self.sig_v, self.eps_tot_v, self.u
        u_prev = getattr(self, "_u_last_step", None)
        if u_prev is None:
            u_prev = u
        rows, failed = [], False
        for t, dt in zip(ts, dts):
            if failed:
                rows.append([0.0, 1.0, 0.0, 0.0, 0.0, 0.0])
                continue
            x0 = u + (u - u_prev)
            (st_n, sv_n, eps_n, u_n, sv_k, ite, err, stats) = \
                self._fixed_point(states, sv, eps_v, x0,
                                  *self._step_inputs(t), dt, tol, maxiter)
            conv = math.isfinite(err) and err <= tol
            if conv:
                states = self._commit(st_n, sv_n, sv_k, dt)
                u_prev = u
                sv, eps_v, u = sv_n, eps_n, u_n
            failed = not conv
            rows.append([float(ite), err, float(stats[0]), float(stats[1]),
                         stats[2], float(conv)])
        for e, st in zip(self.mat.elems_ne, states):
            e.state = st
        self.sig_v, self.eps_tot_v, self.u = sv, eps_v, u
        self._u_last_step = u_prev
        self._last_sv_k = sv
        stats = np.asarray(rows, dtype=np.float64).reshape(-1, 6)
        done = np.nonzero(stats[:, 5] > 0.5)[0]
        if done.size:
            last = stats[done[-1]]
            self.krylov_total = int(last[2])
            self.solver_stats = (int(last[3]), float(last[4]))
        else:
            self.krylov_total = 0
            self.solver_stats = (0, float("nan"))
        self.run_after_solve()
        return stats
