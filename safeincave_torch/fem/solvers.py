"""Matrix-free Krylov solvers (CG, BiCGStab) and the mixed-precision
iterative-refinement loop (port of safeincave_tpu/fem/solvers.py).

The JAX package runs each loop as a ``lax.while_loop``; here each loop is a
Python loop whose condition is read on the host every iteration (one device
sync per iteration), with the same breakdown guards, stopping tests and
pass structure.

Convergence: ||r|| <= max(rtol ||b||, atol) on the true residual.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def _vdot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _nonzero(x):
    """``x`` where nonzero, else 1 (safe denominator)."""
    return torch.where(x != 0, x, torch.ones_like(x))


def cg_solve(A: Callable, b, x0, M_inv, rtol=1e-12, atol=0.0, maxiter=200):
    """Preconditioned conjugate gradients for SPD operators.

    Returns (x, iterations, final residual norm (0-dim tensor))."""
    b_norm = torch.sqrt(_vdot(b, b))
    tol2 = float(torch.clamp(rtol * b_norm, min=atol) ** 2)
    x = x0
    r = b - A(x0)
    z = M_inv(r)
    p = z
    rz = _vdot(r, z)
    k = 0
    rr = float(_vdot(r, r))
    while rr > tol2 and k < maxiter and math.isfinite(rr):
        Ap = A(p)
        alpha = rz / _nonzero(_vdot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = _vdot(r, z)
        beta = rz_new / _nonzero(rz)
        p = z + beta * p
        rz = rz_new
        k += 1
        rr = float(_vdot(r, r))
    return x, k, torch.sqrt(_vdot(r, r))


def bicgstab_solve(A: Callable, b, x0, M_inv, rtol=1e-12, atol=0.0,
                   maxiter=200):
    """Preconditioned BiCGStab for (mildly) non-symmetric operators.

    A breakdown (rho or omega collapsing relative to the residual scale)
    stops the iteration; the caller restarts from the true residual.
    Returns (x, iterations, final residual norm (0-dim tensor))."""
    b_norm = torch.sqrt(_vdot(b, b))
    tol2 = float(torch.clamp(rtol * b_norm, min=atol) ** 2)
    eps = torch.finfo(b.dtype).eps

    x = x0
    r = b - A(x0)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho, alpha, omega = one, one, one
    k = 0
    broke = False
    rr_t = _vdot(r, r)
    rr = float(rr_t)
    while rr > tol2 and k < maxiter and not broke and math.isfinite(rr):
        rho_new = _vdot(rhat, r)
        broke_t = rho_new.abs() < eps * eps * rr_t
        beta = (rho_new / _nonzero(rho)) * (alpha / _nonzero(omega))
        p = r + beta * (p - omega * v)
        phat = M_inv(p)
        v = A(phat)
        alpha = rho_new / _nonzero(_vdot(rhat, v))
        s = r - alpha * v
        shat = M_inv(s)
        t = A(shat)
        tt = _vdot(t, t)
        broke_t = broke_t | (tt == 0)
        omega = _vdot(t, s) / _nonzero(tt)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
        rr_t = _vdot(r, r)
        rr, broke = torch.stack([rr_t, broke_t.to(rr_t.dtype)]).tolist()
    return x, k, torch.sqrt(_vdot(r, r))


def ir_solve(A_hi: Callable, A_lo: Callable, b, x0, M_inv_lo,
             inner_solve: Callable = bicgstab_solve,
             rtol=1e-12, atol=0.0, inner_rtol=3e-5, inner_maxiter=300,
             max_passes=12):
    """Mixed-precision defect correction: f32 Krylov under f64 refinement.

    Each pass solves ``A_lo d = r / ||r||`` in f32, applies ``x += ||r|| d``
    and recomputes the true f64 residual; a pass is kept only if it reduced
    that residual.  Stops at ``||r|| <= max(rtol ||b||, atol)``, at
    ``max_passes``, or when a pass fails to halve the residual.

    Returns (x, total inner iterations, final f64 residual norm)."""
    b_norm = torch.sqrt(_vdot(b, b))
    tol = float(torch.clamp(rtol * b_norm, min=atol))

    x = x0
    r = b - A_hi(x0)
    rnorm_t = torch.sqrt(_vdot(r, r))
    rnorm, rnorm_prev = float(rnorm_t), math.inf
    k_tot = 0
    passes = 0
    while (rnorm > tol and passes < max_passes and rnorm < 0.5 * rnorm_prev
           and math.isfinite(rnorm)):
        scale = rnorm_t if rnorm > 0 else torch.ones_like(rnorm_t)
        rhs = (r / scale).to(torch.float32)
        d, k, _ = inner_solve(A_lo, rhs, torch.zeros_like(rhs), M_inv_lo,
                              rtol=inner_rtol, maxiter=inner_maxiter)
        x_try = x
        if math.isfinite(float(_vdot(d, d))):
            x_try = x + scale * d.to(b.dtype)
        r_try = b - A_hi(x_try)
        rn_try_t = torch.sqrt(_vdot(r_try, r_try))
        rn_try = float(rn_try_t)
        rnorm_prev = rnorm
        if math.isfinite(rn_try) and rn_try < rnorm:
            x, r, rnorm_t, rnorm = x_try, r_try, rn_try_t, rn_try
        k_tot += k
        passes += 1
    return x, k_tot, rnorm_t
