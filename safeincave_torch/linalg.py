"""Batched small dense linear algebra (port of safeincave_tpu/linalg.py).

``inv6x6_fast`` keeps the JAX package's unpivoted Gauss-Jordan with a
per-element singularity flag: the flag drives the elastic fallback of
``Material.f_CT``, which ``torch.linalg.inv`` (raising or returning inf on
a singular batch entry) cannot provide.  ``inv6x6`` is the pivoted variant
with the same flag, and ``eigvalsh3x3`` the analytic eigenvalues of
symmetric 3x3 batches that the Matsuoka-Nakai model differentiates through.
"""
from __future__ import annotations

import math

import torch


def inv6x6(M: torch.Tensor, pivot_tol: float = 1e-30):
    """Invert (..., 6, 6) matrices by Gauss-Jordan with partial pivoting.

    Returns ``(inv, ok (...,) bool)``: ``ok`` is False where a pivot fell
    below ``pivot_tol`` (after scaling by the matrix's largest entry) or an
    entry was non-finite; ``inv`` is then garbage."""
    n = 6
    batch_shape = M.shape[:-2]
    raw_scale = M.abs().amax(dim=(-2, -1))
    ok = torch.isfinite(raw_scale) & (raw_scale > 0)
    norm = torch.where(raw_scale > 0, raw_scale, torch.ones_like(raw_scale))
    M = M / norm[..., None, None]

    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    aug = torch.cat([M, eye], dim=-1)                     # (..., 6, 12)
    rows = torch.arange(n, device=M.device)

    for k in range(n):
        col = aug[..., :, k]
        # only rows >= k are pivot candidates
        cand = torch.where(rows >= k, col.abs(), -torch.ones_like(col))
        p = cand.argmax(dim=-1)[..., None]                # (..., 1)
        # swap rows k and p: row k reads from p, row p reads from k
        perm = rows.expand(batch_shape + (n,))
        perm = torch.where(rows == k, p,
                           torch.where(perm == p, torch.full_like(perm, k),
                                       perm))
        aug = torch.take_along_dim(aug, perm[..., None], dim=-2)

        piv = aug[..., k, k]
        ok = ok & (piv.abs() > pivot_tol) & torch.isfinite(piv)
        piv_safe = torch.where(piv.abs() > 0, piv, torch.ones_like(piv))
        pivot_row = aug[..., k, :] / piv_safe[..., None]
        factors = aug[..., :, k]
        elim = aug - factors[..., None] * pivot_row[..., None, :]
        aug = torch.where((rows == k)[:, None], pivot_row[..., None, :], elim)

    return aug[..., :, n:] / norm[..., None, None], ok


def solve6x6(M: torch.Tensor, b: torch.Tensor):
    """Solve batched 6x6 systems through :func:`inv6x6`; returns
    ``(x, ok)``."""
    inv, ok = inv6x6(M)
    return torch.einsum("...ij,...j->...i", inv, b), ok


def inv6x6_fast(M: torch.Tensor, pivot_tol: float = 1e-30):
    """Invert (E, 6, 6) matrices by diagonal Gauss-Jordan in the stacked
    (6, 12, E) layout.  Returns ``(inv (E, 6, 6), ok (E,) bool)``; ``ok`` is
    False where a pivot degenerated or an entry was non-finite (``inv`` is
    then garbage and the caller substitutes its fallback)."""
    n = 6
    Mt = M.permute(1, 2, 0)                               # (6, 6, E)
    raw = Mt.abs().amax(dim=(0, 1))                       # (E,)
    ok = torch.isfinite(raw) & (raw > 0)
    norm = torch.where(raw > 0, raw, torch.ones_like(raw))
    Mt = Mt / norm
    eye = torch.eye(n, dtype=M.dtype, device=M.device)[:, :, None]
    aug = torch.cat([Mt, eye.expand(n, n, Mt.shape[-1])], dim=1)
    for k in range(n):
        piv = aug[k, k]
        ok = ok & (piv.abs() > pivot_tol) & torch.isfinite(piv)
        row_k = aug[k] / torch.where(piv.abs() > 0, piv,
                                     torch.ones_like(piv))
        factors = aug[:, k]                               # (6, E)
        aug = aug - factors[:, None, :] * row_k[None, :, :]
        aug[k] = row_k
    inv = aug[:, n:, :].permute(2, 0, 1) / norm[:, None, None]
    return inv, ok


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of (..., 3, 3) matrices, normalized
    by each matrix's max magnitude first."""
    s = M.abs().amax(dim=(-2, -1), keepdim=True)
    s = torch.where(s > 0, s, torch.ones_like(s))
    M = M / s
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det != 0, det, torch.ones_like(det))
    row0 = torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1)
    row1 = torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1)
    row2 = torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1)
    inv = torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]
    return inv / s


def eigvalsh3x3(A: torch.Tensor) -> torch.Tensor:
    """Analytic eigenvalues of (..., 3, 3) symmetric matrices, ascending
    (trigonometric Cardano method)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 ** 2 + b11 ** 2 + b22 ** 2
          + 2.0 * (a01 ** 2 + a02 ** 2 + a12 ** 2))
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    p_safe = torch.where(p > 0, p, torch.ones_like(p))

    # det(B) / 2 with B = (A - q I) / p
    detB = (b00 * (b11 * b22 - a12 ** 2)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detB / (2.0 * p_safe ** 3), -1.0, 1.0)

    phi = torch.arccos(r) / 3.0
    e_max = q + 2.0 * p * torch.cos(phi)
    e_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_max - e_min

    isotropic = p2 <= 1e-300
    e_max = torch.where(isotropic, q, e_max)
    e_mid = torch.where(isotropic, q, e_mid)
    e_min = torch.where(isotropic, q, e_min)
    return torch.stack([e_min, e_mid, e_max], dim=-1)
