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
the host, with the same update sequence.  On CUDA the early iterations of a
step run as a float32 sweep (``SolverSettings.fp32_phase``) before the f64
finish, as the JAX package does on an accelerator.

Not ported yet (queued in ROADMAP.md): tangent lagging, adaptive inner
tolerances, the bf16 dense preconditioner, halo mode and thermal coupling.
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

    ``fp32_phase``: "auto" runs the early fixed-point iterations of each
    time step entirely in float32 while the strain-change error is above
    ``fp32_switch``, on an equation on CUDA (off on the CPU, as the JAX
    package decides by backend); True/False force it.  Convergence is only
    declared after a float64 iteration.
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
    fp32_switch: float = 1e-4

    def __post_init__(self):
        for name in ("adaptive_rtol", "lag_tangent"):
            if getattr(self, name):
                raise NotImplementedError(
                    f"{name}=True is not ported yet (queued in ROADMAP.md)")

    def fp32_enabled(self, device=None) -> bool:
        """Whether the f32 sweep runs for an equation on ``device`` (default:
        :func:`default_device`, which raises without a CUDA device); "auto"
        means on CUDA only."""
        if self.fp32_phase == "auto":
            dev = torch.device(device) if device is not None \
                else default_device()
            return dev.type == "cuda"
        return bool(self.fp32_phase)

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


def _f64_action(kern, CT_hi):
    """(f64 stiffness action, f64 planes or None) of one linearized solve.

    A general (not structured) block-DIA operator assembles f64 planes and
    applies them with the DIA kernel; otherwise the action is the cumsum
    matvec (a structured box assembles only the f32 planes, which are cheap,
    and keeps the exact f64 action matrix-free)."""
    dia = kern.dia
    if dia is not None and not dia.structured:
        planes = dia.assemble(CT_hi)
        return dia.operator(planes), planes
    return (lambda x: kern.matvec(CT_hi, x)), None


def _f32_action(kern, CT, planes_hi):
    """The f32 Krylov operator of one linearized solve: the f32 cast of the
    general DIA planes, the DIA planes assembled from the f32 tangent on a
    structured box, the band kernel, or the f32 cumsum matvec."""
    dia = kern.dia
    if planes_hi is not None:
        return dia.operator(planes_hi.to(F32))
    CT_lo = kern.prep(CT.to(F32))
    if dia is not None:
        return dia.operator(dia.assemble(CT_lo))
    if kern.band is not None:
        return kern.band.operator(kern.band.pack_ct(CT_lo))
    return lambda x: kern.matvec(CT_lo, x)


def _make_masked_solver(kern, settings: SolverSettings, apply_M,
                        zero_dirichlet: bool = False):
    """Build ``solve_lin(CT, b, mask, u_bc, x0, rtol, P) -> (x, iters, res,
    b_eff_norm)``.

    Dirichlet conditions by masking + lifting; ``b_eff_norm`` is the norm
    of the right-hand side actually solved.  The operators are chosen by
    :func:`_f64_action` and :func:`_f32_action`.  When the mixed passes
    stagnate above the target, the solve finishes in f64 from the best
    mixed iterate and keeps whichever residual is smaller.
    ``zero_dirichlet`` drops the lifting matvec A @ u_bc, which is zero for
    homogeneous supports.
    """
    solve = settings.solve_fn()
    mixed = settings.precision == "mixed"

    def solve_lin(CT, b, mask, u_bc, x0, rtol, P):
        CT_hi = kern.prep(CT)
        mv_hi, planes_hi = _f64_action(kern, CT_hi)
        free = 1.0 - mask

        def Aop(x):
            return mask * mv_hi(mask * x) + free * x

        def M_inv(r):
            return apply_M(P, r, mask)

        if zero_dirichlet:
            b_eff = mask * b
        else:
            b_eff = mask * (b - mv_hi(u_bc)) + free * u_bc
        b_eff_norm = torch.sqrt(torch.dot(b_eff.reshape(-1),
                                          b_eff.reshape(-1)))
        if not mixed:
            x, k, res = solve(Aop, b_eff, x0, M_inv, rtol=rtol,
                              maxiter=settings.max_it)
            return x, k, res, b_eff_norm

        mask32 = mask.to(F32)
        free32 = 1.0 - mask32
        mv_lo = _f32_action(kern, CT, planes_hi)

        def Aop32(x):
            return mask32 * mv_lo(mask32 * x) + free32 * x

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


def _make_solve32(kern, settings: SolverSettings, apply_M,
                  zero_dirichlet: bool = False):
    """Build ``solve32(CT, b, x0, rtol, mask32, ubc32, P) -> (x, iters,
    res)`` for the f32 sweep: defect correction (at most 4 passes) on the
    f32 tangent ``CT`` (6, 6, E), with the residuals in f64 and the Krylov
    passes on the f32 operator.  A raw f32 BiCGStab can diverge on the
    Desai-coupled tangent; restarting each pass from an f64 residual cures
    that for one f64 matvec per pass.  Returns f32 ``x`` and ``res``."""
    solve = settings.solve_fn()

    def solve32(CT, b, x0, rtol, mask32, ubc32, P):
        mask64, ubc64 = mask32.to(F64), ubc32.to(F64)
        mv64, planes64 = _f64_action(kern, CT.to(F64))
        mv32 = _f32_action(kern, CT, planes64)

        def Aop_hi(x):
            return mask64 * mv64(mask64 * x) + (1.0 - mask64) * x

        def Aop_lo(x):
            return mask32 * mv32(mask32 * x) + (1.0 - mask32) * x

        def M_inv(r):
            return apply_M(P, r, mask32)

        b64 = b.to(F64)
        if zero_dirichlet:
            b_eff = mask64 * b64
        else:
            b_eff = mask64 * (b64 - mv64(ubc64)) + (1.0 - mask64) * ubc64
        x, k, res = ir_solve(Aop_hi, Aop_lo, b_eff, x0.to(F64), M_inv,
                             inner_solve=solve, rtol=rtol,
                             inner_rtol=settings.inner_rtol,
                             inner_maxiter=settings.max_it, max_passes=4)
        return x.to(F32), k, res.to(F32)

    return solve32


def select_backend(grid, device):
    """The stiffness backend :class:`LinearMomentum` tries on ``device``,
    as the JAX package selects on an accelerator: on CUDA, "dia" for a
    natural (not reordered) numbering and "band" for a band-ordered grid;
    None (the cumsum operator alone) otherwise."""
    if torch.device(device).type != "cuda":
        return None
    method = getattr(grid, "reorder_method", None)
    if method in (None, "natural"):
        return "dia"
    return "band" if method == "band" else None


# state keys that stay frozen during a step's fixed point (committed
# history, written only by the commit); the f32 sweep's copies are replaced
# by the f64 entry values, so the f64 finish solves the same problem as a
# pure-f64 run
_FROZEN = ("eps_old", "rate_old", "qsi_old", "zeta_old")


def _to(state, dtype):
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in state.items()}


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
        self.q_nodes = z(self.n_nodes)
        self.q_elems = z(self.n_elems)
        self.p_nodes = z(self.n_nodes)
        self.p_elems = z(self.n_elems)
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

    # -- invariants and their smoothing (output fields) -------------------- #
    def _q_dg0(self):
        """Von Mises stress sqrt(3 J2) per element."""
        s = self.sig_v
        I1 = s[:, 0] + s[:, 1] + s[:, 2]
        I2 = (s[:, 0] * s[:, 1] + s[:, 1] * s[:, 2] + s[:, 0] * s[:, 2]
              - s[:, 3] ** 2 - s[:, 4] ** 2 - s[:, 5] ** 2)
        J2 = I1 ** 2 / 3.0 - I2
        return torch.sqrt(torch.clamp(3.0 * J2, min=0.0))

    def _p_dg0(self):
        """Mean stress per element."""
        return (self.sig_v[:, 0] + self.sig_v[:, 1] + self.sig_v[:, 2]) / 3.0

    def compute_q_nodes(self):
        self.q_nodes = self.grid.elems_to_nodes(self._q_dg0())

    def compute_q_elems(self):
        self.q_elems = self.grid.smooth_elems(self._q_dg0())

    def compute_p_nodes(self):
        self.p_nodes = self.grid.elems_to_nodes(self._p_dg0())

    def compute_p_elems(self):
        self.p_elems = self.grid.smooth_elems(self._p_dg0())

    # -- strain / internal-variable orchestration -------------------------- #
    def compute_total_strain(self):
        self.eps_tot_v = self.kernel.strain(self.u)
        return self.eps_tot_v

    def compute_eps_ne_k(self, dt):
        """Sum of the mechanisms' theta-scheme predictors (E, 6)."""
        eps_k = torch.zeros((self.n_elems, 6), dtype=F64, device=self.device)
        for e in self.mat.elems_ne:
            e.compute_eps_ne_k(dt * self.theta, dt * (1 - self.theta))
            eps_k = eps_k + e.state["eps_k"]
        return eps_k

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

    def increment_internal_variables(self, stress, stress_k, dt):
        sv = self._f64(_as_voigt(stress))
        sv_k = self._f64(_as_voigt(stress_k))
        for e in self.mat.elems_ne:
            e.state = e.f_increment_isv(e.state, sv, sv_k, dt)

    def update_internal_variables(self):
        for e in self.mat.elems_ne:
            e.state = e.f_commit_isv(e.state)

    # -- dt-retry snapshots ------------------------------------------------ #
    def save_internal_state(self):
        """Snapshot every mechanism's state dict.  The snapshot shares the
        tensors: every ``f_*`` update returns new tensors and none writes
        into a state tensor in place, so a later step leaves them as they
        were."""
        self._saved_state = [dict(e.state) for e in self.mat.elems_ne]

    def restore_internal_state(self):
        for e, st in zip(self.mat.elems_ne, self._saved_state):
            e.state = dict(st)

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

    On CUDA the stiffness backend follows :func:`select_backend`, as the JAX
    package selects on an accelerator: a natural-order grid gets the
    assembled block-DIA operator with its CUDA kernel (a numbering that
    :class:`~safeincave_torch.fem.dia.DIAPlan` refuses keeps the cumsum
    operator), a band-ordered grid the band kernel as the f32 Krylov
    operator.  A kernel that fails to build or launch raises.

    ``fp32_accepted`` counts the steps whose f32 sweep the health gate
    accepted.
    """

    def __init__(self, grid, theta: float, auto_backend: bool = True,
                 device=None):
        super().__init__(grid, theta, device)
        self._precond = None
        self._reset_solvers()
        self.fp32_accepted = 0
        backend = select_backend(grid, self.device) if auto_backend else None
        if backend == "dia":
            try:
                self.kernel.enable_dia()
            except ValueError:
                pass    # not offset-structured: keep the cumsum operator
        elif backend == "band":
            self.kernel.enable_band()

    def _reset_solvers(self):
        self._solve_lin = None
        self._solve32 = None

    def enable_band_matvec(self):
        """Route the f32 Krylov stiffness action through the band kernel
        (on the CPU its plain twin)."""
        self.kernel.enable_band()
        self._reset_solvers()

    def enable_dia_matvec(self, max_offsets: int = 96,
                          min_fill: float = 0.4):
        """Route the Krylov stiffness action through the assembled block-DIA
        operator (on the CPU its plain twin).  Raises ValueError when the
        node numbering is not offset-structured."""
        self.kernel.enable_dia(max_offsets=max_offsets, min_fill=min_fill)
        self._reset_solvers()

    def set_solver(self, solver):
        super().set_solver(solver)
        self._precond = None
        self._reset_solvers()

    def set_boundary_conditions(self, bc):
        super().set_boundary_conditions(bc)
        self._precond = None
        self._reset_solvers()

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

    def _get_solve32(self):
        if self._solve32 is None:
            _, apply_M = self._get_precond()
            self._solve32 = _make_solve32(
                self.kernel, self.solver, apply_M,
                zero_dirichlet=self.bc.all_zero_dirichlet)
        return self._solve32

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
    def _fp32_sweep(self, states, sv, eps_v, u, b_ext, mask, u_bc, dt,
                    maxiter, P):
        """The f32 sweep of a step's fixed point and its health gate.

        The f64 body's update sequence runs in float32 (materials,
        assembly, Krylov, stress and internal variables) while the
        strain-change error is above ``fp32_switch`` and halves every
        iteration, for at most min(maxiter - 2, 6) iterations.  Each solve
        is only as tight as the iteration needs (rtol = 0.05 err clipped to
        [1e-6, 1e-2]); an iterate that is not finite or did not halve the
        residual is replaced by the initial guess.

        The gate restores the frozen history from the f64 entry state and
        accepts the sweep only if its error reached ``fp32_switch``, every
        value is finite, |sigma| < 1e9 Pa, |eps| < 0.5 and no hardening
        variable moved more than 30 % from its entry value; otherwise the
        f64 phase starts from the entry state.  Host syncs: two per sweep
        iteration besides the Krylov loops', and one for the gate.

        Returns (states, sv, eps_v, u, iterations, err, krylov_total,
        krylov_last), iterations 0 and err 1.0 for a rejected sweep."""
        mat, kern, theta = self.mat, self.kernel, self.theta
        elems_ne = list(mat.elems_ne)
        switch = self.solver.fp32_switch
        solve32 = self._get_solve32()
        b32, mask32, ubc32 = b_ext.to(F32), mask.to(F32), u_bc.to(F32)
        Temp32 = self.Temp.to(F32)
        dt = float(np.float32(dt))
        phi1, phi2 = dt * theta, dt * (1 - theta)
        st32 = [_to(st, F32) for st in states]
        sv32, eps32, u32 = sv.to(F32), eps_v.to(F32), u.to(F32)
        w = voigt_weight(sv32)

        ite, err, prog, kry_tot, kry = 0, 1.0, True, 0, 0
        while (err > switch and ite < min(maxiter - 2, 6)
               and math.isfinite(err) and prog):
            err_prev, sv_k = err, sv32
            new_states, G, B6 = mat.f_tangent_all(st32, sv_k, Temp32, dt,
                                                  theta)
            CT = kern.prep(mat.f_CT(G, dt, theta))
            eps_ne_k = torch.zeros_like(sv32)
            states2 = []
            for e, st in zip(elems_ne, new_states):
                st = e.f_eps_k(st, phi1, phi2)
                eps_ne_k = eps_ne_k + st["eps_k"]
                states2.append(st)
            eps_rhs = eps_ne_k - phi2 * (B6 + kern.apply66(kern.prep(G),
                                                           sv_k))
            b = b32 + kern.internal_force(kern.apply66(CT, eps_rhs))
            x0 = mask32 * u32 + (1.0 - mask32) * ubc32
            lin_rtol = min(max(0.05 * err_prev, 1e-6), 1e-2)
            u_new, kry, lin_res = solve32(CT, b, x0, lin_rtol, mask32, ubc32,
                                          P)
            b_norm = torch.sqrt(torch.dot(b.reshape(-1), b.reshape(-1)))
            u_ok = (torch.isfinite(torch.dot(u_new.reshape(-1),
                                             u_new.reshape(-1)))
                    & torch.isfinite(lin_res) & (lin_res < 0.5 * b_norm))
            if not bool(u_ok):
                u_new = x0
            eps_new = kern.strain(u_new)
            sv_new = kern.apply66(CT, eps_new - eps_rhs)
            states3 = []
            for e, st in zip(elems_ne, states2):
                st = e.f_increment_isv(st, sv_new, sv_k, dt)
                st = e.f_rate(st, sv_new, phi1, Temp32)
                states3.append(st)
            diff = torch.sqrt((((eps_new - eps32) ** 2) * w).sum())
            ref = torch.sqrt(((eps_new ** 2) * w).sum())
            err = float(torch.where(torch.isfinite(sv_new).all(), diff / ref,
                                    math.inf))
            prog = err < 0.5 * err_prev
            kry_tot += kry
            st32, sv32, eps32, u32 = states3, sv_new, eps_new, u_new
            ite += 1

        new = [{k: (o[k] if k in _FROZEN else v) for k, v in _to(st, F64)
                .items()} for o, st in zip(states, st32)]
        sv64, eps64, u64 = sv32.to(F64), eps32.to(F64), u32.to(F64)
        ok = math.isfinite(err) and err <= switch
        if ok:
            checks = [sv64.abs().max() < 1e9, eps64.abs().max() < 0.5]
            for o, st in zip(states, new):
                for k in ("alpha", "zeta"):
                    if k in st:
                        checks.append(((st[k] - o[k]).abs()
                                       <= 0.3 * o[k].abs() + 1e-6).all())
            leaves = [v for st in new for v in st.values()]
            checks += [torch.isfinite(a).all()
                       for a in leaves + [sv64, eps64, u64]
                       if a.is_floating_point()]
            ok = bool(torch.stack(checks).all())
        if not ok:
            return states, sv, eps_v, u, 0, 1.0, kry_tot, kry
        self.fp32_accepted += 1
        return new, sv64, eps64, u64, ite, err, kry_tot, kry

    def _fixed_point(self, states, sv, eps_v, u, b_ext, mask, u_bc, dt, tol,
                     maxiter, fp32_on=True):
        """One time step's fixed-point iteration: tangent -> CT -> eps_rhs
        -> Krylov -> strain -> stress -> ISV increment -> rates ->
        strain-change error, until ``err <= tol`` (after at least one f64
        iteration), ``maxiter``, or a non-finite error.  When the f32 phase
        is enabled (and ``fp32_on``), :meth:`_fp32_sweep` runs first and
        its iterations count towards ``maxiter``.

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

        ite, err, sv_k, first = 0, 1.0, sv, True
        kry_tot, kry, lin_res = 0, 0, 0.0
        if (fp32_on and not trivial_error
                and self.solver.fp32_enabled(self.device)):
            (states, sv, eps_v, u, ite, err, kry_tot, kry) = \
                self._fp32_sweep(states, sv, eps_v, u, b_ext, mask, u_bc,
                                 dt, maxiter, P)
        while (err > tol and ite < maxiter and math.isfinite(err)) or first:
            first = False
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
        phase.  A true ``_fp32_disable`` attribute (set by a dt-retry) runs
        the step without the f32 sweep."""
        u_prev = getattr(self, "_u_last_step", None)
        u0 = self.u if u_prev is None else self.u + (self.u - u_prev)
        self._u_last_step = self.u
        (states, sv, eps_v, u, sv_k, ite, err, stats) = self._fixed_point(
            [e.state for e in self.mat.elems_ne], self.sig_v, self.eps_tot_v,
            u0, *self._step_inputs(t), dt, tol, maxiter,
            fp32_on=not getattr(self, "_fp32_disable", False))
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
