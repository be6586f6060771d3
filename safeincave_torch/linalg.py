"""Batched small dense linear algebra (port of safeincave_tpu/linalg.py).

``inv6x6_fast`` keeps the JAX package's unpivoted Gauss-Jordan with a
per-element singularity flag: the flag drives the elastic fallback of
``Material.f_CT``, which ``torch.linalg.inv`` (raising or returning inf on
a singular batch entry) cannot provide.
"""
from __future__ import annotations

import torch


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
