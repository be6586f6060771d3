"""Linear momentum equation: matrix-free theta-scheme inelastic solver.

Port of ``safeincave_tpu/fem/momentum.py`` (the always-fresh, always-tight
float64 fixed point that the cavern benchmark runs).  One linearized step:

    CT  = (C_inv + dt(1-theta) G)^-1                       (consistent tangent)
    eps_rhs = eps_ne_k + eps_th - dt(1-theta)(B + G:sigma_k)
    a(du, v) = <CT eps(du), eps(v)>          (matrix-free stiffness action)
    L(v)     = body + neumann + <CT eps_rhs, eps(v)>
    solve by preconditioned Krylov with Dirichlet masking/lifting

The JAX package runs a time step as one jitted ``lax.while_loop``.  Here
the fixed point is a Python loop with the same update sequence: on CUDA each
iteration replays three captured graphs (the tangent suite, the right-hand
side, the update with its packed statistics; fem/graphs.py) around the
linear solve, whose Krylov loops test their stopping conditions on the
device and replay in blocks (fem/solvers.py).  The host reads one packed
tensor per Krylov block and one per fixed-point iteration, and decides
rebuilds, tolerances, rollbacks and solve acceptance from them.  On CUDA the
early iterations of a step run as a float32 sweep
(``SolverSettings.fp32_phase``) before the f64 finish, as the JAX package
does on an accelerator.

``solve_tm_time_steps`` advances the coupled thermo-mechanical step (heat
step, nodal-to-element temperature, thermal strain, fixed point, commit)
over a chunk of time steps.

``SolverSettings.lag_tangent`` and ``adaptive_rtol`` change the iteration
path of that fixed point (fewer tangent builds, looser early solves with a
rollback net), never its convergence criterion.  The reference-style
mutating methods (``compute_CT``, ``compute_eps_rhs``, ``compute_stress``,
``solve``) drive one linearized step by hand.

An equation converted by ``parallel.shard_equation(..., mode="halo")``
carries a :class:`~safeincave_torch.parallel.halo.HaloMomentumSolver` in
``_halo``: its preconditioners and linear solves then run on the
owner-blocked part layout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from .._device import default_device
from ..linalg import inv3x3
from ..materials.base import _as_voigt, apply66
from ..materials.viscoplastic import MohrCoulombViscoplastic
from ..utils import voigt_to_tensor, voigt_weight
from .graphs import Graphs
from .kernels import F32, F64, MomentumKernel
from .solvers import (_SPECS, _ir, _krylov, _vdot, bicgstab_solve, cg_solve,
                      ir_solve)
from .symdense import SymDense


@dataclass
class SolverSettings:
    """Krylov settings.

    ``precision="mixed"`` runs the Krylov iterations in f32 under an f64
    defect-correction loop (fem/solvers.py:ir_solve); convergence is still
    the f64 relative residual ``rtol``.  ``precision="f64"`` runs everything
    in f64.

    ``precond``: "dense" is the dense f32 inverse of the masked elastic
    operator, built once per wiring, symmetrized and kept as its packed
    upper triangle (about (3 n_nodes)^2 / 2 f32 of device memory, gated by
    ``dense_max_dofs``), applied twice per BiCGStab iteration (once per CG
    iteration) by a hand kernel that reads the triangle once
    (fem/symdense.py); "2level" is block-Jacobi plus a dense coarse
    correction over ``coarse_agg`` consecutive nodes; "jacobi" is nodal
    3x3 blocks.  "auto" picks dense on CUDA below the gate and 2level
    otherwise, as the JAX package does on an accelerator and on the CPU.

    ``precond_bf16`` stores the whole dense inverse, unsymmetrized, in
    bfloat16 and applies it with float32 accumulation (torch ops): the
    device memory of the packed f32 triangle, at the price of more Krylov
    iterations.

    Every method other than "cg" runs BiCGStab, as in the JAX package.

    ``adaptive_rtol`` solves the linearized systems only about two decades
    tighter than the fixed-point error (``clip(0.05 err, rtol, 1e-4)``) until
    the error is within 10x of the step's tolerance, then at ``rtol`` for
    good; a loose iteration that stalls its solve, blows the stress past
    three times the entry scale or goes non-finite rolls the step back to its
    entry state and continues tight-only.  ``lag_tangent`` (ignored when
    ``adaptive_rtol`` is on) rebuilds the consistent tangent suite only on
    the first float64 iteration, after an iteration whose error did not
    contract to 0.7 of the last, and once the error is within 10x of the
    tolerance; every solve stays at ``rtol``.  In both modes convergence is
    declared only on an iteration that was tight and ran a fresh tangent, so
    committed fields satisfy the same criterion as the default path.

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
    precond_bf16: bool = False
    coarse_agg: int = 16        # nodes per coarse aggregate
    adaptive_rtol: bool = False
    lag_tangent: bool = False
    fp32_phase: object = "auto"
    fp32_switch: float = 1e-4

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
    blk = torch.as_tensor(kern.block_diagonal(C), dtype=F64,
                          device=kern.device)
    m = torch.as_tensor(mask, dtype=F64, device=kern.device)
    blk = blk * m[:, :, None] * m[:, None, :]
    blk = blk + (1.0 - m)[:, :, None] * torch.eye(3, dtype=F64,
                                                  device=kern.device)[None]
    return inv3x3(blk)


def _blk_apply(inv, r):
    """(N, 3, 3) block apply."""
    inv_t = inv.permute(1, 2, 0).to(r.dtype)                      # (3, 3, N)
    return (inv_t * r.T[None]).sum(1).T


def _coarse_space(kern, C, mask, G, agg_of_node=None):
    """Dense coarse operator over aggregates of G consecutive node ids (or
    over ``agg_of_node`` (n_nodes,), the aggregate of each node, for callers
    whose restriction is a segment sum anyway: parallel/halo.py), from the
    per-element stiffness with Dirichlet rows/cols masked, inverted in f32
    after scaling to O(1), diagonal regularization and symmetrization (an
    unsymmetrized f32 inverse can turn the preconditioner indefinite).
    Returns (coarse_inv, n_agg, pad)."""
    n_nodes = kern.n_nodes
    if agg_of_node is None:
        n_agg = -(-n_nodes // G)
    else:
        agg_of_node = np.asarray(agg_of_node, dtype=np.int64)
        n_agg = int(agg_of_node.max()) + 1
    pad = n_agg * G - n_nodes
    conn = kern.conn_np
    Ke = kern.element_stiffness(C)
    mrows = mask[conn]                                            # (E,4,3)
    Ke = Ke * mrows[:, :, :, None, None] * mrows[:, None, None, :, :]
    agg = conn // G if agg_of_node is None else agg_of_node[conn]
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


_BF16_ROWS = 4096    # rows of the bf16 inverse widened to f32 per product


def build_preconditioner(kern, C, mask, settings: SolverSettings):
    """(P, apply) for the masked operator, built once per wiring from the
    constant elastic stiffness ``C`` and the Dirichlet ``mask``;
    ``apply(P, r, mask)`` works in r's dtype.  On an element-sharded
    kernel ``C`` is gathered from every rank first; the dense and coarse
    inverses, built from the whole mesh, are made on rank 0 and broadcast,
    and the block diagonal is summed over the ranks."""
    C = kern.gather_elems(C)
    C = C.cpu().numpy() if isinstance(C, torch.Tensor) else np.asarray(C)
    mask = (mask.cpu().numpy() if isinstance(mask, torch.Tensor)
            else np.asarray(mask))
    mode = settings.precond
    if mode == "auto":
        mode = ("dense" if kern.device.type == "cuda"
                and 3 * kern.n_nodes <= settings.dense_max_dofs else "2level")

    if mode == "dense":
        (inv,) = kern.from_rank0(
            lambda: (_dense_inverse_precond(kern, C, mask),))
        if not settings.precond_bf16:
            # symmetrized and packed to its upper triangle (fem/symdense.py);
            # the full inverse is freed when this returns
            def apply_dense(P, r, m):
                (sym,) = P
                return sym(r.reshape(-1).to(F32)).reshape(-1, 3).to(r.dtype)

            return (SymDense(inv),), apply_dense

        def apply_dense_bf16(P, r, m):
            # bf16 operands, f32 products and sums: row blocks of the
            # inverse are widened one at a time, so the apply never holds
            # a second full-size matrix
            (inv,) = P
            r32 = r.reshape(-1).to(inv.dtype).to(F32)
            x = torch.cat([torch.mv(blk.to(F32), r32)
                           for blk in inv.split(_BF16_ROWS)])
            return x.reshape(-1, 3).to(r.dtype)

        return (inv.to(torch.bfloat16),), apply_dense_bf16

    blk_inv = _block_jacobi_arrays(kern, C, mask)
    if mode == "2level":
        G = settings.coarse_agg
        coarse_inv, n_agg, pad = kern.from_rank0(
            lambda: _coarse_space(kern, C, mask, G))

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


def _assembled(kern):
    """The assembled operator of ``kern``: block-DIA when the numbering is
    offset-structured, else block-ELL when it was enabled, else None."""
    return kern.dia if kern.dia is not None else kern.blockell


def _cumsum_operator(kern):
    """``CT_soa -> (x -> A(CT) x)`` on the cumsum matvec."""
    return lambda CT_soa: (lambda x: kern.matvec(CT_soa, x))


def _f64_action(kern, CT_hi):
    """(make, data, planes) of one linearized solve's f64 stiffness action
    ``make(data)``; ``planes`` are the f64 planes, or None.

    A general (not structured) block-DIA operator, or a block-ELL one,
    assembles f64 planes and applies them; otherwise the action is the
    cumsum matvec (a structured box assembles only the f32 planes, which are
    cheap, and keeps the exact f64 action matrix-free)."""
    op = _assembled(kern)
    if op is not None and not op.structured:
        planes = op.assemble(CT_hi)
        return op.operator, planes, planes
    return _cumsum_operator(kern), CT_hi, None


def _f32_action(kern, CT, planes_hi):
    """(make, data) of the f32 Krylov operator ``make(data)`` of one
    linearized solve: the f32 cast of the general DIA or block-ELL planes,
    the DIA planes assembled from the f32 tangent on a structured box, the
    band kernel, or the f32 cumsum matvec."""
    op = _assembled(kern)
    if planes_hi is not None:
        return op.operator, planes_hi.to(F32)
    CT_lo = kern.prep(CT.to(F32))
    if op is not None:
        return op.operator, op.assemble(CT_lo)
    if kern.band is not None:
        return kern.band.operator, kern.band.pack_ct(CT_lo)
    return _cumsum_operator(kern), CT_lo


def _make_masked_solver(kern, settings: SolverSettings, apply_M, graphs,
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

    On CUDA the Krylov blocks replay from ``graphs`` (one graph per
    operator, precision and preconditioner): the operators and masks they
    close over are bound buffers, refreshed once per solve.  The decisions
    read the host values the blocks' packed reads brought back.
    """
    spec = _SPECS[settings.solve_fn()]
    mixed = settings.precision == "mixed"
    run = graphs.runner("lin")
    bind = graphs.bind

    def solve_lin(CT, b, mask, u_bc, x0, rtol, P):
        make_hi, data_hi, planes_hi = _f64_action(kern, kern.prep(CT))
        mv_hi = make_hi(bind("lin.hi", data_hi))
        mask = bind("lin.mask", mask)
        free = bind("lin.free", 1.0 - mask)

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
            x, k, res, _ = _krylov(spec, Aop, b_eff, x0, M_inv, rtol, 0.0,
                                   settings.max_it, _vdot, run)
            return x, k, res, b_eff_norm

        mask32 = bind("lin.mask32", mask.to(F32))
        free32 = bind("lin.free32", 1.0 - mask32)
        make_lo, data_lo = _f32_action(kern, CT, planes_hi)
        mv_lo = make_lo(bind("lin.lo", data_lo))

        def Aop32(x):
            return mask32 * mv_lo(mask32 * x) + free32 * x

        def M_inv32(r):
            return apply_M(P, r, mask32)

        x, k, res, res_h, bnorm_h = _ir(
            Aop, Aop32, b_eff, x0, M_inv32, settings.solve_fn(), rtol, 0.0,
            settings.inner_rtol, settings.max_it, settings.max_passes, _vdot,
            run)
        if res_h > rtol * bnorm_h:
            x2, k2, res2, res2_h = _krylov(spec, Aop, b_eff, x, M_inv, rtol,
                                           0.0, settings.max_it, _vdot, run)
            k += k2
            if math.isfinite(res2_h) and res2_h < res_h:
                x, res = x2, res2
        return x, k, res, b_eff_norm

    return solve_lin


def _make_solve32(kern, settings: SolverSettings, apply_M, graphs,
                  zero_dirichlet: bool = False):
    """Build ``solve32(CT, b, x0, rtol, mask32, ubc32, P) -> (x, iters,
    res)`` for the f32 sweep: defect correction (at most 4 passes) on the
    f32 tangent ``CT`` (6, 6, E), with the residuals in f64 and the Krylov
    passes on the f32 operator.  A raw f32 BiCGStab can diverge on the
    Desai-coupled tangent; restarting each pass from an f64 residual cures
    that for one f64 matvec per pass.  Returns f32 ``x`` and ``res``.  On
    CUDA its blocks replay from ``graphs``, as the masked solver's do."""
    run = graphs.runner("sweep")
    bind = graphs.bind

    def solve32(CT, b, x0, rtol, mask32, ubc32, P):
        mask64 = bind("sweep.mask64", mask32.to(F64))
        mask32 = bind("sweep.mask32", mask32)
        ubc64 = ubc32.to(F64)
        make64, data64, planes64 = _f64_action(kern, CT.to(F64))
        mv64 = make64(bind("sweep.hi", data64))
        make32, data32 = _f32_action(kern, CT, planes64)
        mv32 = make32(bind("sweep.lo", data32))

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
                             inner_solve=settings.solve_fn(), rtol=rtol,
                             inner_rtol=settings.inner_rtol,
                             inner_maxiter=settings.max_it, max_passes=4,
                             run=run)
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


def _step_error(kern, eps_new, eps_old, sv_new, w, trivial=False):
    """(strain-change error, count of non-finite stress entries), 0-dim
    tensors over every rank's elements, in one reduction: the error
    ||eps_new - eps_old||_w / ||eps_new||_w (0 when ``trivial``)."""
    n_bad = (~torch.isfinite(sv_new)).sum().to(eps_new.dtype)
    if trivial:
        return torch.zeros_like(n_bad), kern.global_sum(n_bad)
    sums = kern.global_sum(torch.stack([
        (((eps_new - eps_old) ** 2) * w).sum(), ((eps_new ** 2) * w).sum(),
        n_bad]))
    return torch.sqrt(sums[0]) / torch.sqrt(sums[1]), sums[2]


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
        """Wire the material and call :meth:`initialize`, the hook a
        subclass overrides to add fields of its own."""
        self.mat = material
        self.initialize()

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
        """Von Mises stress sqrt(3 J2) per element (every rank's)."""
        s = self.kernel.gather_elems(self.sig_v)
        I1 = s[:, 0] + s[:, 1] + s[:, 2]
        I2 = (s[:, 0] * s[:, 1] + s[:, 1] * s[:, 2] + s[:, 0] * s[:, 2]
              - s[:, 3] ** 2 - s[:, 4] ** 2 - s[:, 5] ** 2)
        J2 = I1 ** 2 / 3.0 - I2
        return torch.sqrt(torch.clamp(3.0 * J2, min=0.0))

    def _p_dg0(self):
        """Mean stress per element (every rank's)."""
        s = self.kernel.gather_elems(self.sig_v)
        return (s[:, 0] + s[:, 1] + s[:, 2]) / 3.0

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

    def compute_eps_th(self):
        """Thermal strain (E, 6) of ``Temp - T0``, summed over the
        material's thermoelastic elements; None without one, so that a
        material without thermal coupling solves what it always did."""
        if not self.mat.elems_th:
            return None
        dT = self.Temp - self.T0
        eps_th = self.mat.elems_th[0].eps_th_voigt(dT)
        for th in self.mat.elems_th[1:]:
            eps_th = eps_th + th.eps_th_voigt(dT)
        return eps_th

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

    # -- output fields: the whole mesh at its true element count, gathered
    # from every rank of a sharded equation (every rank reads them)
    @property
    def sig(self):
        return voigt_to_tensor(self._whole(self.sig_v))

    @property
    def eps_tot(self):
        return voigt_to_tensor(self._whole(self.eps_tot_v))

    def _whole(self, x):
        return self.kernel.gather_elems(x)[:self.kernel.n_elems_orig]


class LinearMomentum(LinearMomentumBase):
    """Concrete formulation.

    On CUDA the stiffness backend follows :func:`select_backend`, as the JAX
    package selects on an accelerator: a natural-order grid gets the
    assembled block-DIA operator with its CUDA kernel (a numbering that
    :class:`~safeincave_torch.fem.dia.DIAPlan` refuses keeps the cumsum
    operator), a band-ordered grid the band kernel as the f32 Krylov
    operator.  A kernel that fails to build or launch raises.

    ``fp32_accepted`` counts the steps whose f32 sweep the health gate
    accepted; ``fp_iterations_total``, ``krylov_iterations_total``,
    ``tangent_builds_total`` and ``rollbacks_total`` run over every step
    since the wiring (:meth:`counters` gathers them).  Every committed step
    adds, per Mohr-Coulomb mechanism, its elements that can flow and are on
    the yield surface at the committed stress to a count kept on the device
    (no host read per step), and the elements that can flow to
    ``mc_elem_steps``.
    """

    def __init__(self, grid, theta: float, auto_backend: bool = True,
                 device=None):
        super().__init__(grid, theta, device)
        self.eps_rhs_v = torch.zeros((self.n_elems, 6), dtype=F64,
                                     device=self.device)
        self._precond = None
        self._halo = None         # set by parallel.shard_equation(mode="halo")
        self._reset_solvers()
        self.fp32_accepted = 0
        # fixed-point bookkeeping of the last step, beside krylov_total,
        # and running totals over every step since the wiring
        self.tangent_builds = self.rollbacks = 0
        self.tangent_builds_total = self.rollbacks_total = 0
        self.fp_iterations_total = self.krylov_iterations_total = 0
        self._mc_yield = torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        self.mc_elem_steps = 0
        backend = select_backend(grid, self.device) if auto_backend else None
        if backend == "dia":
            try:
                self.kernel.enable_dia()
            except ValueError:
                pass    # not offset-structured: keep the cumsum operator
        elif backend == "band":
            self.kernel.enable_band()

    def counters(self):
        """The running counts whose deltas a run record keeps
        (:mod:`~safeincave_torch.tracing`): graph replays and captures,
        hand-kernel launches, fixed-point and Krylov iterations, tangent
        builds, rollbacks, accepted float32 sweeps, and the Mohr-Coulomb
        elements on the yield surface summed over committed steps
        (``mc_yield_elems``) over the elements that can flow, summed alike
        (``mc_elem_steps``).  The yield count is copied from the device
        here, once per call, and by no read method of a tensor."""
        kern = self.kernel
        band, dia = getattr(kern, "band", None), getattr(kern, "dia", None)
        sym = self._sym_dense()
        return {"replays": self.graphs.replays,
                "captures": self.graphs.captures,
                "band_launches": band.launches if band is not None else 0,
                "dia_launches": dia.launches if dia is not None else 0,
                "precond_launches": sym.launches if sym is not None else 0,
                "fp_iterations": self.fp_iterations_total,
                "krylov_iterations": self.krylov_iterations_total,
                "tangent_builds": self.tangent_builds_total,
                "rollbacks": self.rollbacks_total,
                "fp32_accepted": self.fp32_accepted,
                "mc_yield_elems": int(self._mc_yield.cpu().numpy()),
                "mc_elem_steps": self.mc_elem_steps}

    def _reset_solvers(self):
        """Drop the linear solvers and the captured graphs (the
        preconditioner, backend or kernel they referenced changed).  The
        parallel layer's equations run uncaptured."""
        self._solve_lin = None
        self._solve32 = None
        if getattr(self, "graphs", None) is not None:
            self.graphs.clear()
        self.graphs = Graphs(
            self.device, counters=lambda: (self.kernel.band, self.kernel.dia,
                                           self._sym_dense()),
            enabled=self._halo is None and type(self.kernel) is MomentumKernel)

    def _sym_dense(self):
        """The packed dense preconditioner, once built, or None."""
        P = self._precond[0] if self._precond is not None else ()
        return P[0] if len(P) == 1 and isinstance(P[0], SymDense) else None

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

    def enable_blockell_matvec(self, G: int = 8):
        """Route the Krylov stiffness action (both precisions) through the
        assembled block-ELL operator (fem/blockell.py): one assembly per
        linearized solve, then every matvec is a gather of neighbour groups
        and a batched multiply-reduce.  Any node ordering works; a
        locality-preserving one keeps the neighbour count K small.  Never
        selected automatically."""
        self.kernel.enable_blockell(G=G)
        self._reset_solvers()

    def initialize(self):
        self.C = self.mat.C
        self.graphs.clear()      # they captured the old material's tensors

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

    # -- reference-style mutating path: one linearized step by hand ------- #
    def compute_CT(self, stress_k, dt):
        sv_k = self._f64(_as_voigt(stress_k))
        states, G, B6 = self.mat.f_tangent_all(
            [e.state for e in self.mat.elems_ne], sv_k, self.Temp, dt,
            self.theta)
        for e, st in zip(self.mat.elems_ne, states):
            e.state = st
        self.mat.G = G
        self.mat.B6 = B6
        self.mat.CT = self.mat.f_CT(G, dt, self.theta)

    def compute_stress(self, eps_tot, *_):
        ev = self._f64(_as_voigt(eps_tot))
        self.sig_v = apply66(self.mat.CT, ev - self.eps_rhs_v)
        return self.sig_v

    def compute_eps_rhs(self, dt, stress_k):
        sv_k = self._f64(_as_voigt(stress_k))
        eps = self.compute_eps_ne_k(dt)
        eps_th = self.compute_eps_th()
        if eps_th is not None:
            eps = eps + eps_th
        G_sk = apply66(self.mat.G, sv_k)
        self.eps_rhs_v = eps - dt * (1 - self.theta) * (self.mat.B6 + G_sk)

    # ------------------------------------------------------------------ #
    def _get_precond(self):
        """(P, apply), built once per wiring from C and the Dirichlet mask.
        In halo mode the arrays live in the padded part layout: "jacobi"
        takes the halo block-Jacobi, every other setting the halo two-level
        preconditioner over ``coarse_agg`` nodes per aggregate (never the
        dense inverse)."""
        if self._precond is None:
            if not hasattr(self.bc, "mask"):
                self.bc.update_dirichlet(0.0)
            tracing.begin(tracing.PRECOND)
            if self._halo is not None:
                from ..parallel.halo import halo_block_jacobi, halo_two_level
                if self.solver.precond == "jacobi":
                    self._precond = halo_block_jacobi(
                        self._halo, self.mat.C, self.bc.mask)
                else:
                    self._precond = halo_two_level(
                        self._halo, self.mat.C, self.bc.mask,
                        G=self.solver.coarse_agg)
            else:
                self._precond = build_preconditioner(
                    self.kernel, self.mat.C, self.bc.mask, self.solver)
            if tracing.enabled() and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            tracing.end(tracing.PRECOND)
        return self._precond

    def _get_solver(self):
        if self._solve_lin is None:
            _, apply_M = self._get_precond()
            zero_dir = self.bc.all_zero_dirichlet
            if self._halo is not None:
                from ..parallel.halo import make_halo_masked_solver
                self._solve_lin = make_halo_masked_solver(
                    self._halo, self.solver, apply_M, zero_dirichlet=zero_dir)
            else:
                self._solve_lin = _make_masked_solver(
                    self.kernel, self.solver, apply_M, self.graphs,
                    zero_dirichlet=zero_dir)
        return self._solve_lin

    def _get_solve32(self):
        if self._solve32 is None:
            _, apply_M = self._get_precond()
            zero_dir = self.bc.all_zero_dirichlet
            if self._halo is not None:
                from ..parallel.halo import make_halo_solve32
                self._solve32 = make_halo_solve32(
                    self._halo, self.solver, apply_M, zero_dirichlet=zero_dir)
            else:
                self._solve32 = _make_solve32(
                    self.kernel, self.solver, apply_M, self.graphs,
                    zero_dirichlet=zero_dir)
        return self._solve32

    def _linear_solve(self, CT, b):
        """Solve a(CT) u = b with Dirichlet masking + lifting."""
        mask, u_bc = self.bc.mask, self.bc.u_bc
        x0 = mask * self.u + (1.0 - mask) * u_bc
        P, _ = self._get_precond()
        x, iters, res, _ = self._get_solver()(CT, b, mask, u_bc, x0,
                                              self.solver.rtol, P)
        self.solver_stats = (iters, float(tracing.read(res)))
        return x

    def solve_elastic_response(self):
        """Purely elastic boundary value problem."""
        b = self.b_body + self.bc.b_neumann
        self.u = self._linear_solve(self.mat.C, b)
        self.run_after_solve()

    def solve(self, stress_k, t, dt):
        """One linearized inelastic step about ``stress_k``."""
        self.compute_CT(stress_k, dt)
        self.compute_eps_rhs(dt, stress_k)
        b_rhs = self.kernel.internal_force(apply66(self.mat.CT,
                                                   self.eps_rhs_v))
        b = self.b_body + self.bc.b_neumann + b_rhs
        self.u = self._linear_solve(self.mat.CT, b)
        self.run_after_solve()

    # -- one fixed-point iteration's three pieces, each a graph on CUDA --- #
    def _tangent(self, states, sv_k, Temp, dt):
        """The tangent suite about ``sv_k``: (states, G (6, 6, E), CT
        (6, 6, E), B), in the dtype of ``sv_k``."""
        mat, kern, theta = self.mat, self.kernel, self.theta

        def suite(states, sv_k, Temp):
            new_states, G, B6 = mat.f_tangent_all(states, sv_k, Temp, dt,
                                                  theta)
            return (new_states, kern.prep(G),
                    kern.prep(mat.f_CT(G, dt, theta)), B6)

        span = tracing.dev_begin(self.device)
        out = self.graphs(("tangent", float(dt), theta), suite, states, sv_k,
                          Temp)
        tracing.dev_end("tangent", span)
        return out

    def _rhs(self, states, G_p, B6, CT, sv_lin, eps_th, b_ext, u, mask,
             u_bc, dt):
        """(states with their theta-scheme predictors, eps_rhs, the
        right-hand side b, the Krylov guess x0) of a linearization about
        ``sv_lin``."""
        kern, elems_ne = self.kernel, list(self.mat.elems_ne)
        phi1, phi2 = dt * self.theta, dt * (1 - self.theta)

        def rhs(states, G_p, B6, CT, sv_lin, eps_th, b_ext, u, mask, u_bc):
            eps_ne_k = torch.zeros_like(sv_lin)
            states2 = []
            for e, st in zip(elems_ne, states):
                st = e.f_eps_k(st, phi1, phi2)
                eps_ne_k = eps_ne_k + st["eps_k"]
                states2.append(st)
            G_sk = kern.apply66(G_p, sv_lin)
            if eps_th is not None:
                eps_ne_k = eps_ne_k + eps_th
            eps_rhs = eps_ne_k - phi2 * (B6 + G_sk)
            b = b_ext + kern.internal_force(kern.apply66(CT, eps_rhs))
            return states2, eps_rhs, b, mask * u + (1.0 - mask) * u_bc

        return self.graphs(("rhs", float(dt), self.theta), rhs, states, G_p,
                           B6, CT, sv_lin, eps_th, b_ext, u, mask, u_bc)

    def _update(self, u_new, CT, eps_rhs, states, sv_lin, Temp, eps_old, w,
                res, bnorm, dt, guard=None, trivial=False):
        """Strain, stress, internal-variable increment and rates of a solve's
        ``u_new``, and the packed statistics the host reads once per
        fixed-point iteration: f64 [error, non-finite stress entries,
        ``res``, ``bnorm``, |u_new|^2, max|stress|].  ``guard`` = (x0, b)
        (the f32 sweep) replaces a ``u_new`` that is not finite or did not
        halve the residual by ``x0``, ``bnorm`` then being ||b||.
        Returns (u_new, eps_new, sv_new, states, stats)."""
        kern, elems_ne = self.kernel, list(self.mat.elems_ne)
        phi1 = dt * self.theta

        def update(u_new, CT, eps_rhs, states, sv_lin, Temp, eps_old, w, res,
                   bnorm, guard):
            if guard is not None:
                x0, b = guard
                bnorm = torch.sqrt(torch.dot(b.reshape(-1), b.reshape(-1)))
                u_ok = (torch.isfinite(torch.dot(u_new.reshape(-1),
                                                 u_new.reshape(-1)))
                        & torch.isfinite(res) & (res < 0.5 * bnorm))
                u_new = torch.where(u_ok, u_new, x0)
            eps_new = kern.strain(u_new)
            sv_new = kern.apply66(CT, eps_new - eps_rhs)
            states3 = []
            for e, st in zip(elems_ne, states):
                st = e.f_increment_isv(st, sv_new, sv_lin, dt)
                st = e.f_rate(st, sv_new, phi1, Temp)
                states3.append(st)
            err, n_bad = _step_error(kern, eps_new, eps_old, sv_new, w,
                                     trivial)
            uu = torch.dot(u_new.reshape(-1), u_new.reshape(-1))
            sv_max = kern.global_max(sv_new.abs().max())
            stats = torch.stack([v.to(F64) for v in (err, n_bad, res, bnorm,
                                                     uu, sv_max)])
            return u_new, eps_new, sv_new, states3, stats

        return self.graphs(("update", float(dt), self.theta, trivial), update,
                           u_new, CT, eps_rhs, states, sv_lin, Temp, eps_old,
                           w, res, bnorm, guard)

    # ------------------------------------------------------------------ #
    def _fp32_sweep(self, states, sv, eps_v, u, b_ext, mask, u_bc, eps_th,
                    dt, maxiter, P):
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
        f64 phase starts from the entry state.  Host reads: one per sweep
        iteration besides the Krylov blocks', and one for the gate.

        Returns (states, sv, eps_v, u, iterations, err, krylov_total,
        krylov_last), iterations 0 and err 1.0 for a rejected sweep."""
        tracing.begin(tracing.SWEEP)
        kern = self.kernel
        switch = self.solver.fp32_switch
        solve32 = self._get_solve32()
        b32, mask32, ubc32 = b_ext.to(F32), mask.to(F32), u_bc.to(F32)
        Temp32 = self.Temp.to(F32)
        eps_th32 = None if eps_th is None else eps_th.to(F32)
        dt = float(np.float32(dt))
        st32 = [_to(st, F32) for st in states]
        sv32, eps32, u32 = sv.to(F32), eps_v.to(F32), u.to(F32)
        w = voigt_weight(sv32)

        ite, err, prog, kry_tot, kry = 0, 1.0, True, 0, 0
        while (err > switch and ite < min(maxiter - 2, 6)
               and math.isfinite(err) and prog):
            err_prev, sv_k = err, sv32
            new_states, G_p, CT, B6 = self._tangent(st32, sv_k, Temp32, dt)
            states2, eps_rhs, b, x0 = self._rhs(
                new_states, G_p, B6, CT, sv_k, eps_th32, b32, u32, mask32,
                ubc32, dt)
            lin_rtol = min(max(0.05 * err_prev, 1e-6), 1e-2)
            span = tracing.dev_begin(self.device)
            u_new, kry, lin_res = solve32(CT, b, x0, lin_rtol, mask32, ubc32,
                                          P)
            tracing.dev_end("solve", span)
            u_new, eps_new, sv_new, states3, stats = self._update(
                u_new, CT, eps_rhs, states2, sv_k, Temp32, eps32, w, lin_res,
                None, dt, guard=(x0, b))
            err, n_bad = tracing.read(stats)[:2]
            err = err if n_bad == 0 else math.inf
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
            # every rank's checks: the gate is one decision
            failed = (~torch.stack(checks).all()).to(F64)
            ok = not tracing.read(kern.global_max(failed))
        tracing.end(tracing.SWEEP)
        if not ok:
            return states, sv, eps_v, u, 0, 1.0, kry_tot, kry
        self.fp32_accepted += 1
        return new, sv64, eps64, u64, ite, err, kry_tot, kry

    def _fixed_point(self, states, sv, eps_v, u, b_ext, mask, u_bc, dt, tol,
                     maxiter, fp32_on=True, eps_th=None):
        """One time step's fixed-point iteration: tangent -> CT -> eps_rhs
        -> Krylov -> strain -> stress -> ISV increment -> rates ->
        strain-change error, until ``err <= tol`` after a tight iteration
        on a fresh tangent, ``maxiter``, or a non-finite error.  When the
        f32 phase is enabled (and ``fp32_on``), :meth:`_fp32_sweep` runs
        first and its iterations count towards ``maxiter``.  ``eps_th`` is
        the step's thermal strain (:meth:`compute_eps_th`), constant over
        the iteration.

        On CUDA an iteration is three graph replays (:meth:`_tangent`,
        :meth:`_rhs`, :meth:`_update`) around the linear solve's Krylov
        blocks; the host reads the update's packed statistics once per
        iteration and makes every decision below from them.

        By default every iteration rebuilds the tangent suite and solves at
        ``rtol``.  With ``lag_tangent`` or ``adaptive_rtol``
        (:class:`SolverSettings`) an iteration may reuse the suite of the
        last build: G, CT and B are carried here, the mechanisms'
        linearization scalars stay in their state dicts, and ``eps_rhs``
        and the ISV increment expand about ``sv_lin``, the stress of that
        build.  Whether to rebuild is decided on the host from the errors
        the loop reads anyway.  A loose (adaptive) iteration whose solve
        stalled, whose stress passed ``3 |sv_entry|max + 1e7`` or whose
        error is not finite rolls states, stress, strain and displacement
        back to the step's entry values, sets the error to 1 and keeps the
        rest of the step tight.

        A diverged solve, a tight solve stalled more than 4 decades above
        its target, or a non-finite stress sets the error to inf so the
        step fails instead of reading as converged.

        Returns (states, sv, eps_v, u, sv_k, iterations, err,
        (krylov_total, krylov_last, lin_res, tangent_builds, rollbacks))."""
        tracing.begin(tracing.FIXED_POINT)
        kern, theta = self.kernel, self.theta
        trivial_error = theta == 1.0 or not self.mat.elems_ne
        adaptive = self.solver.adaptive_rtol and not trivial_error
        lag = (self.solver.lag_tangent and not self.solver.adaptive_rtol
               and not trivial_error)
        rtol = self.solver.rtol
        P, _ = self._get_precond()
        solve_lin = self._get_solver()
        w = voigt_weight(sv)

        # the entry snapshot shares its tensors with the live state: every
        # update below makes new tensors (a graph's outputs are clones),
        # none writes in place
        entry = (states, sv, eps_v, u)
        sv_scale = tracing.read(kern.global_max(sv.abs().max())) \
            if adaptive else 0.0
        ite, err, sv_k, first = 0, 1.0, sv, True
        kry_tot, kry, lin_res = 0, 0, 0.0
        if (fp32_on and not trivial_error
                and self.solver.fp32_enabled(self.device)):
            (states, sv, eps_v, u, ite, err, kry_tot, kry) = \
                self._fp32_sweep(states, sv, eps_v, u, b_ext, mask, u_bc,
                                 eps_th, dt, maxiter, P)
        was_tight, have, contracted = False, False, True
        G_p = CT = B6 = None
        sv_lin = sv
        builds = rollbacks = 0
        while (((err > tol or not was_tight) and ite < maxiter
                and math.isfinite(err)) or first):
            first = False
            err_prev, sv_k = err, sv
            tight, lin_rtol = True, rtol
            if adaptive:
                tight = was_tight or err_prev <= 10.0 * tol
                if not tight:
                    lin_rtol = min(max(0.05 * err_prev, rtol), 1e-4)
                rebuild = not have or tight or not contracted
            elif lag:
                rebuild = (not have or not contracted
                           or err_prev <= 10.0 * tol)
            else:
                rebuild = True
            if rebuild:
                new_states, G_p, CT, B6 = self._tangent(states, sv_k,
                                                        self.Temp, dt)
                sv_lin = sv_k
                builds += 1
            else:
                new_states = states
            states2, eps_rhs, b, x0 = self._rhs(
                new_states, G_p, B6, CT, sv_lin, eps_th, b_ext, u, mask, u_bc,
                dt)
            span = tracing.dev_begin(self.device)
            u_new, kry, res_t, bnorm_t = solve_lin(CT, b, mask, u_bc, x0,
                                                   lin_rtol, P)
            tracing.dev_end("solve", span)
            u_new, eps_new, sv_new, states3, stats = self._update(
                u_new, CT, eps_rhs, states2, sv_lin, self.Temp, eps_v, w,
                res_t, bnorm_t, dt, trivial=trivial_error)
            err, n_bad, lin_res, lin_bnorm, uu, sv_max = tracing.read(stats)
            # solve acceptance: a diverged solve, or a tight one stalled
            # more than 4 decades above its target, fails the step (err=inf
            # -> dt-retry); a loose one gets one decade and the rollback
            rel_res = lin_res / (lin_bnorm + 1e-300)
            stalled = not rel_res <= (1e4 if tight else 10.0) * lin_rtol
            solve_ok = (math.isfinite(lin_res)
                        and lin_res <= 10.0 * lin_bnorm + 1e-30
                        and not (tight and stalled) and math.isfinite(uu))
            if not (solve_ok and n_bad == 0):
                err = math.inf
            bad = not tight and (stalled or not math.isfinite(err)
                                 or sv_max > 3.0 * sv_scale + 1e7)
            if bad:
                states3, sv_new, eps_new, u_new = entry
                sv_k, err = entry[1], 1.0
                rollbacks += 1
            have = (have or rebuild) and not bad
            contracted = bad or err < 0.7 * err_prev
            was_tight = (tight and rebuild) or bad
            kry_tot += kry
            states, sv, eps_v, u = states3, sv_new, eps_new, u_new
            ite += 1
        self.tangent_builds_total += builds
        self.rollbacks_total += rollbacks
        self.fp_iterations_total += ite
        self.krylov_iterations_total += kry_tot
        tracing.end(tracing.FIXED_POINT)
        return (states, sv, eps_v, u, sv_k, ite, err,
                (kry_tot, kry, lin_res, builds, rollbacks))

    def _commit(self, states, sv, sv_k, dt):
        tracing.begin(tracing.COMMIT)
        out = []
        for e, st in zip(self.mat.elems_ne, states):
            st = e.f_commit_isv(st)
            st = e.f_rate_to_old(st)
            st = e.f_update_eps_old(st, sv, sv_k, dt * (1 - self.theta))
            out.append(st)
            if isinstance(e, MohrCoulombViscoplastic):
                self._mc_yield += e.yield_count(st)
                self.mc_elem_steps += e.n_flowing
        tracing.end(tracing.COMMIT)
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
        tracing.begin(tracing.STEP)
        u_prev = getattr(self, "_u_last_step", None)
        u0 = self.u if u_prev is None else self.u + (self.u - u_prev)
        self._u_last_step = self.u
        (states, sv, eps_v, u, sv_k, ite, err, stats) = self._fixed_point(
            [e.state for e in self.mat.elems_ne], self.sig_v, self.eps_tot_v,
            u0, *self._step_inputs(t), dt, tol, maxiter,
            fp32_on=not getattr(self, "_fp32_disable", False),
            eps_th=self.compute_eps_th())
        tracing.end(tracing.STEP)
        for e, st in zip(self.mat.elems_ne, states):
            e.state = st
        self.sig_v, self.eps_tot_v, self.u = sv, eps_v, u
        self._last_sv_k = sv_k
        self.krylov_total = stats[0]
        self.solver_stats = (stats[1], stats[2])
        self.tangent_builds, self.rollbacks = stats[3], stats[4]
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
        tracing.begin(tracing.CHUNK)
        step0 = tracing.TRACER.step
        states = [e.state for e in self.mat.elems_ne]
        sv, eps_v, u = self.sig_v, self.eps_tot_v, self.u
        u_prev = getattr(self, "_u_last_step", None)
        if u_prev is None:
            u_prev = u
        eps_th = self.compute_eps_th()
        rows, failed = [], False
        for k, (t, dt) in enumerate(zip(ts, dts)):
            if failed:
                rows.append([0.0, 1.0, 0.0, 0.0, 0.0, 0.0])
                continue
            tracing.at_step(step0 + k)
            tracing.begin(tracing.STEP)
            x0 = u + (u - u_prev)
            (st_n, sv_n, eps_n, u_n, sv_k, ite, err, stats) = \
                self._fixed_point(states, sv, eps_v, x0,
                                  *self._step_inputs(t), dt, tol, maxiter,
                                  eps_th=eps_th)
            tracing.end(tracing.STEP)
            self.tangent_builds, self.rollbacks = stats[3], stats[4]
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
        tracing.end(tracing.CHUNK)
        return stats

    def solve_tm_time_steps(self, heat, ts, dts, tol=1e-6, maxiter=20):
        """Advance up to ``len(ts)`` coupled thermo-mechanical steps; changes
        this equation and ``heat``.

        Per step: implicit heat step -> nodal temperature averaged onto the
        elements -> thermal strain -> extrapolated Krylov guess -> fixed
        point -> commit iff it converged.  On the first step whose fixed
        point does not reach ``tol`` the equation and the heat field are
        left at that step's entry state (the dt-retry restore point) and
        the remaining steps are skipped.

        Returns a (K, 6) float array of rows ``[heat_iters, heat_res,
        fp_iters, error, krylov_total, converged]``; rows after the first
        ``converged == 0`` are ``[0, 0, 0, 1, 0, 0]``."""
        tracing.begin(tracing.CHUNK)
        step0 = tracing.TRACER.step
        states = [e.state for e in self.mat.elems_ne]
        sv, eps_v, u = self.sig_v, self.eps_tot_v, self.u
        u_prev = getattr(self, "_u_last_step", None)
        if u_prev is None:
            u_prev = u
        T, T_old = heat.T, heat.T_old
        rows, failed = [], False
        for k, (t, dt) in enumerate(zip(ts, dts)):
            if failed:
                rows.append([0.0, 0.0, 0.0, 1.0, 0.0, 0.0])
                continue
            tracing.at_step(step0 + k)
            tracing.begin(tracing.STEP)
            T_new, h_it, h_res = heat.step(T, T_old, t, dt)
            self.Temp = heat.kernel.nodes_to_elems(T_new)
            x0 = u + (u - u_prev)
            (st_n, sv_n, eps_n, u_n, sv_k, ite, err, stats) = \
                self._fixed_point(states, sv, eps_v, x0,
                                  *self._step_inputs(t), dt, tol, maxiter,
                                  eps_th=self.compute_eps_th())
            tracing.end(tracing.STEP)
            self.tangent_builds, self.rollbacks = stats[3], stats[4]
            conv = math.isfinite(err) and err <= tol
            if conv:
                states = self._commit(st_n, sv_n, sv_k, dt)
                u_prev = u
                sv, eps_v, u = sv_n, eps_n, u_n
                T = T_old = T_new
            failed = not conv
            rows.append([float(h_it), float(tracing.read(h_res)), float(ite),
                         err, float(stats[0]), float(conv)])
        for e, st in zip(self.mat.elems_ne, states):
            e.state = st
        self.sig_v, self.eps_tot_v, self.u = sv, eps_v, u
        self._u_last_step = u_prev
        self._last_sv_k = sv
        heat.T, heat.T_old = T, T_old
        self.Temp = heat.get_T_elems()
        stats = np.asarray(rows, dtype=np.float64).reshape(-1, 6)
        done = np.nonzero(stats[:, 5] > 0.5)[0]
        if done.size:
            last = stats[done[-1]]
            heat.solver_stats = (int(last[0]), float(last[1]))
            self.krylov_total = int(last[4])
        else:
            heat.solver_stats = (0, float("nan"))
            self.krylov_total = 0
        self.run_after_solve()
        tracing.end(tracing.CHUNK)
        return stats
