"""Per-element 3x3 stiffness blocks as assembly rows.

Port of ``element_block_rows`` and ``element_block_comp_rows`` from
``safeincave_tpu/fem/blockell.py`` (the block-ELL operator itself is not
ported).  The JAX package spells the product out as ~650 elementwise ops to
keep f64 off the TPU's emulated dot units; here it is one batched product
over the (E, 12, 6) strain basis of the P1 element:

    k_e[a, i, b, j] = V_e sum_p w_p eps[a, i, p] sig[b, j, p],
    sig[b, j, p]    = sum_l CT[p, l] eps[b, j, l],

with ``w`` the Voigt contraction weights.  The two output layouts are the
JAX package's: rows (16E, 9) and comp-major rows (144, E).
"""
from __future__ import annotations

import torch

from ..utils import voigt_weight

# tensorial-Voigt nonzero pattern of the P1 strain basis: a unit
# displacement of a node in direction i excites Voigt component p with
# gradient component l and weight c (eps = c * grad_N[l]):   (p, l, c)
_NZ = (
    ((0, 0, 1.0), (3, 1, 0.5), (4, 2, 0.5)),   # i = x -> xx, xy, xz
    ((1, 1, 1.0), (3, 0, 0.5), (5, 2, 0.5)),   # i = y -> yy, xy, yz
    ((2, 2, 1.0), (4, 0, 0.5), (5, 1, 0.5)),   # i = z -> zz, xz, yz
)


def _element_blocks(CT_soa, gn, vol):
    """k_e as (E, 12, 12), row 3a + i, column 3b + j, in CT's dtype.

    CT_soa (6, 6, E), gn (4, 3, E), vol (E,)."""
    dt = CT_soa.dtype
    gn, vol = gn.to(dt), vol.to(dt)
    E = CT_soa.shape[-1]
    eps = torch.zeros((E, 4, 3, 6), dtype=dt, device=CT_soa.device)
    for i, nz in enumerate(_NZ):
        for p, l, c in nz:
            eps[:, :, i, p] = c * gn[:, l].T
    eps = eps.reshape(E, 12, 6)
    sig = eps @ CT_soa.permute(2, 1, 0)            # (E, 12, 6): [e, bj, p]
    weps = eps * (voigt_weight(eps) * vol[:, None])[:, None, :]
    return weps @ sig.transpose(1, 2)              # (E, 12, 12)


def element_block_rows(CT_soa, gn, vol):
    """Rows (16E, 9): row (4a + b) E + e holds k_e[a, i, b, j] at column
    3i + j."""
    K = _element_blocks(CT_soa, gn, vol).reshape(-1, 4, 3, 4, 3)
    return K.permute(1, 3, 0, 2, 4).reshape(-1, 9)


def element_block_comp_rows(CT_soa, gn, vol):
    """Comp-major rows (144, E): row (4a + b) 9 + 3i + j, element axis
    last (the layout of the structured block-DIA assembly)."""
    K = _element_blocks(CT_soa, gn, vol).reshape(-1, 4, 3, 4, 3)
    return K.permute(1, 3, 2, 4, 0).reshape(144, -1)
