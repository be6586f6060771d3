"""Per-element 3x3 stiffness blocks as assembly rows, and the assembled
block-ELL stiffness operator.

Port of ``safeincave_tpu/fem/blockell.py``.  The JAX package spells the
element product out as ~650 elementwise ops to keep f64 off the TPU's
emulated dot units; here it is one batched product over the (E, 12, 6)
strain basis of the P1 element:

    k_e[a, i, b, j] = V_e sum_p w_p eps[a, i, p] sig[b, j, p],
    sig[b, j, p]    = sum_l CT[p, l] eps[b, j, l],

with ``w`` the Voigt contraction weights.  The two output layouts are the
JAX package's: rows (16E, 9) and comp-major rows (144, E).

Block-ELL: nodes are grouped into blocks of ``G`` consecutive nodes; group
``g`` couples to the ``K`` groups that share an element with it.  The
operator is a dense tensor ``B`` (3G, K 3G, Gn), group index last as in the
JAX package, and ``y[i, g] = sum_c B[i, c, g] U[c, g]`` with ``U`` the
gathered neighbour values.  Group ``Gn`` (one past the last real one) is an
all-zero ghost, so slots beyond a group's neighbour count contribute
nothing.  It takes any node order and is never selected automatically.  The
JAX package assembles with a scatter-add; here each distinct node pair sums
its contributions in ascending order through a padded gather, so a run
repeats bit for bit on CUDA as well.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import padded_bins, voigt_weight

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


class BlockELLPlan:
    """Static tables of one mesh (host numpy, built once)."""

    def __init__(self, conn: np.ndarray, n_nodes: int, G: int = 8):
        conn = np.asarray(conn, dtype=np.int64)
        E = conn.shape[0]
        self.G = G
        self.n_nodes = n_nodes
        self.n_elems = E
        Gn = -(-n_nodes // G)
        self.Gn = Gn

        # contribution row r in (ab)-major layout: r = (4a + b) E + e
        rows = np.arange(16 * E)
        a_r = (rows // E) // 4
        b_r = (rows // E) % 4
        e_r = rows % E
        i_r = conn[e_r, a_r]
        j_r = conn[e_r, b_r]

        # group adjacency (ELL slots) from the distinct group pairs
        gi_r, gj_r = i_r // G, j_r // G
        gp_keys = np.unique(gi_r * Gn + gj_r)                # sorted
        gp_g = gp_keys // Gn
        # slot of pair (g, h): rank of h among g's neighbours
        first = np.searchsorted(gp_g, np.arange(Gn))
        gp_slot = np.arange(len(gp_keys)) - first[gp_g]
        K = int(gp_slot.max()) + 1
        self.K = K
        nbr = np.full((Gn, K), Gn, dtype=np.int32)           # ghost = Gn
        nbr[gp_g, gp_slot] = gp_keys % Gn
        self.nbr = nbr

        # contribution row -> flat (g, k, li, lj) slot of the assembly
        # layout (Gn, K, G, G, 3, 3)
        slot_r = gp_slot[np.searchsorted(gp_keys, gi_r * Gn + gj_r)]
        self.row_slot = (((gi_r * K + slot_r) * G + (i_r % G)) * G
                         + (j_r % G)).astype(np.int32)       # (16E,)
        self.n_slots = Gn * K * G * G
        self.n_pairs = int(len(np.unique(i_r * n_nodes + j_r)))

    def nbytes(self, itemsize=8):
        return self.Gn * self.K * (3 * self.G) ** 2 * itemsize


class BlockELL:
    """Assembled operator of one mesh on the kernel's device."""

    structured = False   # both precisions come from one f64 assembly

    def __init__(self, kern, G: int = 8):
        self.plan = p = BlockELLPlan(kern.conn_np, kern.n_nodes, G=G)
        self.device = dev = kern.device
        self._kern = kern
        self.Gn, self.K, self.G = p.Gn, p.K, p.G
        self._nbr = torch.as_tensor(p.nbr.astype(np.int64), device=dev)
        # one slot per distinct node pair; its contribution rows in
        # ascending order, padded with the index of an extra zero row
        slots, pair_of_row = np.unique(p.row_slot, return_inverse=True)
        self._slots = torch.as_tensor(slots.astype(np.int64), device=dev)
        self._rows = torch.as_tensor(padded_bins(pair_of_row, len(slots)),
                                     device=dev)

    def assemble(self, CT_soa):
        """CT (6, 6, E) -> block tensor (3G, K 3G, Gn) in CT's dtype."""
        p = self.plan
        gn, vol = self._kern.geom(CT_soa.dtype)
        v = element_block_rows(CT_soa, gn, vol)              # (16E, 9)
        v = torch.cat([v, v.new_zeros((1, 9))])
        flat = v.new_zeros((p.n_slots, 9))
        flat[self._slots] = v[self._rows].sum(1)
        t = flat.reshape(p.Gn, p.K, p.G, p.G, 3, 3)
        return t.permute(2, 4, 1, 3, 5, 0).reshape(
            3 * p.G, p.K * 3 * p.G, p.Gn).contiguous()

    def matvec(self, blocks, u):
        """Stiffness action A @ u: one gather of neighbour groups and a
        multiply-reduce, in the blocks' dtype; ``u`` (N, 3)."""
        p = self.plan
        G3 = 3 * p.G
        pad = p.Gn * p.G - p.n_nodes
        ug = torch.cat([u.to(blocks.dtype).reshape(-1),
                        blocks.new_zeros(3 * pad + G3)]).reshape(p.Gn + 1, G3)
        U = ug[self._nbr].reshape(p.Gn, p.K * G3).T          # (K 3G, Gn)
        y = (blocks * U[None]).sum(1)                        # (3G, Gn)
        return y.T.reshape(-1)[:3 * p.n_nodes].reshape(-1, 3)

    def operator(self, blocks):
        """``u -> A @ u`` for assembled ``blocks``."""
        return lambda u: self.matvec(blocks, u)
