"""Matrix-free Krylov solvers (CG, BiCGStab) and the mixed-precision
iterative-refinement loop (port of safeincave_tpu/fem/solvers.py).

The JAX package runs each loop as a ``lax.while_loop`` on the device.  Here
each loop keeps the JAX ``cond``/``body`` structure with its stopping test on
the device (residual above the target, count below ``maxiter``, not broken
down, finite) and advances in blocks of :data:`BLOCK` iterations: an
iteration whose test is false leaves every iterate unchanged through
``torch.where`` and adds nothing to the device count, so the iterates and
counts are those of a loop that tests after every iteration, bit for bit,
for any block size.  The host reads one packed tensor per block (the test,
the count, the residual).  ``ir_solve`` runs its defect-correction passes in
the same blocks: at the end of a block whose inner solve has stopped, the
pass is closed (the f64 update and true residual) and the next one opened,
so its reads are one per block too.

``run`` (optional) runs a block: ``run(tag, fn, state) -> (state', out)``
with ``fn(state) -> (state', out)``, as
:meth:`~safeincave_torch.fem.graphs.Graphs.step` replays it from a captured
CUDA graph.  The operator and preconditioner a block closes over then read
buffers that outlive the graph (``Graphs.bind``).  Without ``run`` the block
is called directly.

Convergence: ||r|| <= max(rtol ||b||, atol) on the true residual.

Every solver takes ``dot``, the inner product of its vectors: the plain dot
for whole vectors (one device, or the psum layout whose nodal vectors are
the same on every rank), an all-reduced one for vectors split over ranks
(``HaloMomentumSolver.dot``), so that every rank reads the same numbers and
takes the same branches.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from .. import tracing

F64 = torch.float64

# Krylov iterations per host read, chosen on the card from {1, 2, 4, 8} by
# chip_smoke.py phase 22's sweep at cavern600 (PERF.md section 5).
BLOCK = 2


def _vdot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _nonzero(x):
    """``x`` where nonzero, else 1 (safe denominator)."""
    return torch.where(x != 0, x, torch.ones_like(x))


def _select(go, new, old):
    """``new`` where the 0-dim ``go`` holds, else ``old``, leaf by leaf."""
    return tuple(o if n is o else torch.where(go, n, o)
                 for n, o in zip(new, old))


def _tol2(rtol, atol, b, dot):
    return torch.clamp(rtol * torch.sqrt(dot(b, b)), min=atol) ** 2


class _CG:
    """Preconditioned CG; state (x, r, p, rz, rr, k, tol2)."""
    name, K, RR = "cg", 5, 4

    @staticmethod
    def start(A, b, x0, M_inv, rtol, atol, dot):
        tol2 = _tol2(rtol, atol, b, dot)
        r = b - A(x0)
        p = M_inv(r)
        k = torch.zeros((), dtype=torch.int64, device=b.device)
        return (x0, r, p, dot(r, p), dot(r, r), k, tol2)

    @staticmethod
    def cond(s, maxiter):
        rr, k, tol2 = s[4], s[5], s[6]
        return (rr > tol2) & (k < maxiter) & torch.isfinite(rr)

    @staticmethod
    def body(s, A, M_inv, dot):
        x, r, p, rz, _, k, tol2 = s
        Ap = A(p)
        alpha = rz / _nonzero(dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = dot(r, z)
        beta = rz_new / _nonzero(rz)
        p = z + beta * p
        return (x, r, p, rz_new, dot(r, r), k + 1, tol2)


class _BiCGStab:
    """Preconditioned BiCGStab; state (x, r, p, v, rho, alpha, omega, rr,
    k, broke, rhat, tol2).  A breakdown (rho or omega collapsing relative
    to the residual scale) stops the iteration."""
    name, K, RR = "bicgstab", 8, 7

    @staticmethod
    def start(A, b, x0, M_inv, rtol, atol, dot):
        tol2 = _tol2(rtol, atol, b, dot)
        r = b - A(x0)
        one = torch.ones((), dtype=b.dtype, device=b.device)
        k = torch.zeros((), dtype=torch.int64, device=b.device)
        broke = torch.zeros((), dtype=torch.bool, device=b.device)
        return (x0, r, torch.zeros_like(b), torch.zeros_like(b), one, one,
                one, dot(r, r), k, broke, r, tol2)

    @staticmethod
    def cond(s, maxiter):
        rr, k, broke, tol2 = s[7], s[8], s[9], s[11]
        return ((rr > tol2) & (k < maxiter) & ~broke
                & torch.isfinite(rr))

    @staticmethod
    def body(s, A, M_inv, dot):
        x, r, p, v, rho, alpha, omega, rr, k, _, rhat, tol2 = s
        eps = torch.finfo(r.dtype).eps
        rho_new = dot(rhat, r)
        broke = rho_new.abs() < eps * eps * rr
        beta = (rho_new / _nonzero(rho)) * (alpha / _nonzero(omega))
        p = r + beta * (p - omega * v)
        phat = M_inv(p)
        v = A(phat)
        alpha = rho_new / _nonzero(dot(rhat, v))
        s_ = r - alpha * v
        shat = M_inv(s_)
        t = A(shat)
        tt = dot(t, t)
        broke = broke | (tt == 0)
        omega = dot(t, s_) / _nonzero(tt)
        x = x + alpha * phat + omega * shat
        r = s_ - omega * t
        return (x, r, p, v, rho_new, alpha, omega, dot(r, r), k + 1, broke,
                rhat, tol2)


def _loop(block, state, run, tag):
    """Run ``block`` until the test it reports is false; one host read per
    block.  Returns (state, the last packed stats as floats).  The loop is
    a ``krylov`` span."""
    tracing.begin(tracing.KRYLOV)
    while True:
        state, stats = (block(state) if run is None
                        else run(tag, block, state))
        vals = tracing.read(stats)
        if not vals[0]:
            tracing.end(tracing.KRYLOV)
            return state, vals


def _krylov(spec, A, b, x0, M_inv, rtol, atol, maxiter, dot, run):
    """One Krylov solve; returns (x, iterations, residual norm (0-dim
    tensor), the same norm on the host)."""
    def block(s):
        for _ in range(BLOCK):
            s = _select(spec.cond(s, maxiter), spec.body(s, A, M_inv, dot), s)
        return s, torch.stack([spec.cond(s, maxiter).to(F64),
                               s[spec.K].to(F64), s[spec.RR].to(F64)])

    state = spec.start(A, b, x0, M_inv, rtol, atol, dot)
    state, (_, k, rr) = _loop(block, state, run,
                              ("krylov", spec.name, BLOCK, maxiter))
    x, rr_t = state[0], state[spec.RR]
    if run is not None:
        x, rr_t = x.clone(), rr_t.clone()
    return x, int(k), torch.sqrt(rr_t), math.sqrt(rr)


def cg_solve(A: Callable, b, x0, M_inv, rtol=1e-12, atol=0.0, maxiter=200,
             dot: Callable = _vdot, run=None):
    """Preconditioned conjugate gradients for SPD operators.

    Returns (x, iterations, final residual norm (0-dim tensor))."""
    return _krylov(_CG, A, b, x0, M_inv, rtol, atol, maxiter, dot, run)[:3]


def bicgstab_solve(A: Callable, b, x0, M_inv, rtol=1e-12, atol=0.0,
                   maxiter=200, dot: Callable = _vdot, run=None):
    """Preconditioned BiCGStab for (mildly) non-symmetric operators.

    A breakdown (rho or omega collapsing relative to the residual scale)
    stops the iteration; the caller restarts from the true residual.
    Returns (x, iterations, final residual norm (0-dim tensor))."""
    return _krylov(_BiCGStab, A, b, x0, M_inv, rtol, atol, maxiter, dot,
                   run)[:3]


_SPECS = {cg_solve: _CG, bicgstab_solve: _BiCGStab}


def _ir(A_hi, A_lo, b, x0, M_inv_lo, inner_solve, rtol, atol, inner_rtol,
        inner_maxiter, max_passes, dot, run):
    """:func:`ir_solve`; returns (x, inner iterations, residual norm (0-dim
    tensor), the same norm and ||b|| on the host)."""
    spec = _SPECS.get(inner_solve)
    if spec is None:
        raise ValueError(f"ir_solve: inner_solve must be cg_solve or "
                         f"bicgstab_solve, got {inner_solve!r}")
    lo = torch.float32

    def outer_cond(rnorm, rnorm_prev, passes, tol):
        return ((rnorm > tol) & (passes < max_passes)
                & (rnorm < 0.5 * rnorm_prev) & torch.isfinite(rnorm))

    def open_pass(r, rnorm):
        scale = torch.where(rnorm > 0, rnorm, torch.ones_like(rnorm))
        rhs = (r / scale).to(lo)
        return scale, spec.start(A_lo, rhs, torch.zeros_like(rhs), M_inv_lo,
                                 inner_rtol, 0.0, dot)

    # outer state (x, r, rnorm, rnorm_prev, k_tot, passes, active, scale,
    # b, b_norm, tol), then the inner solve's state
    n_out = 11

    def block(s):
        (x, r, rnorm, rnorm_prev, k_tot, passes, active, scale, b, b_norm,
         tol) = s[:n_out]
        inner = s[n_out:]
        for _ in range(BLOCK):
            go = active & spec.cond(inner, inner_maxiter)
            inner = _select(go, spec.body(inner, A_lo, M_inv_lo, dot), inner)
        # close the pass whose inner solve stopped in this block: accept it
        # only if it REDUCED the true residual (a broken-down or diverged
        # inner solve can return finite garbage)
        done = active & ~spec.cond(inner, inner_maxiter)
        d = inner[0]
        x_try = torch.where(torch.isfinite(dot(d, d)),
                            x + scale * d.to(b.dtype), x)
        r_try = b - A_hi(x_try)
        rn_try = torch.sqrt(dot(r_try, r_try))
        improved = torch.isfinite(rn_try) & (rn_try < rnorm)
        closed = (torch.where(improved, x_try, x),
                  torch.where(improved, r_try, r),
                  torch.where(improved, rn_try, rnorm), rnorm,
                  k_tot + inner[spec.K], passes + 1)
        x, r, rnorm, rnorm_prev, k_tot, passes = _select(
            done, closed, (x, r, rnorm, rnorm_prev, k_tot, passes))
        active = torch.where(done, outer_cond(rnorm, rnorm_prev, passes, tol),
                             active)
        # and open the next one
        opening = done & active
        scale_n, inner_n = open_pass(r, rnorm)
        scale = torch.where(opening, scale_n, scale)
        inner = _select(opening, inner_n, inner)
        state = (x, r, rnorm, rnorm_prev, k_tot, passes, active, scale, b,
                 b_norm, tol) + inner
        return state, torch.stack([active.to(F64), k_tot.to(F64),
                                   rnorm.to(F64), b_norm.to(F64)])

    b_norm = torch.sqrt(dot(b, b))
    tol = torch.clamp(rtol * b_norm, min=atol)
    r = b - A_hi(x0)
    rnorm = torch.sqrt(dot(r, r))
    rnorm_prev = torch.full_like(rnorm, float("inf"))
    zero = torch.zeros((), dtype=torch.int64, device=b.device)
    active = outer_cond(rnorm, rnorm_prev, zero, tol)
    scale, inner = open_pass(r, rnorm)
    state = (x0, r, rnorm, rnorm_prev, zero, zero, active, scale, b, b_norm,
             tol) + inner
    state, (_, k_tot, rnorm_h, b_norm_h) = _loop(
        block, state, run,
        ("ir", spec.name, BLOCK, inner_maxiter, max_passes, inner_rtol))
    x, rnorm = state[0], state[2]
    if run is not None:
        x, rnorm = x.clone(), rnorm.clone()
    return x, int(k_tot), rnorm, rnorm_h, b_norm_h


def ir_solve(A_hi: Callable, A_lo: Callable, b, x0, M_inv_lo,
             inner_solve: Callable = bicgstab_solve,
             rtol=1e-12, atol=0.0, inner_rtol=3e-5, inner_maxiter=300,
             max_passes=12, dot: Callable = _vdot, run=None):
    """Mixed-precision defect correction: f32 Krylov under f64 refinement.

    Each pass solves ``A_lo d = r / ||r||`` in f32 with ``inner_solve``
    (``cg_solve`` or ``bicgstab_solve``), applies ``x += ||r|| d`` and
    recomputes the true f64 residual; a pass is kept only if it reduced
    that residual.  Stops at ``||r|| <= max(rtol ||b||, atol)``, at
    ``max_passes``, or when a pass fails to halve the residual.

    Returns (x, total inner iterations, final f64 residual norm)."""
    return _ir(A_hi, A_lo, b, x0, M_inv_lo, inner_solve, rtol, atol,
               inner_rtol, inner_maxiter, max_passes, dot, run)[:3]
