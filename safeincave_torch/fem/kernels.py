"""Matrix-free CG1 tetrahedron elasticity operator pieces.

Port of ``MomentumKernel`` from ``safeincave_tpu/fem/kernels.py``.  For each
element: gather u -> Voigt strain -> sigma = CT eps -> nodal forces ->
scatter.  Tensors use the JAX package's structure-of-arrays layout with the
element axis last ((6, 6, E) tangents, (4, 3, E) element vectors).

The scatter keeps the JAX package's **cumsum plan**: contributions are
gathered into destination-sorted order, prefix-summed, and each node's sum
is the difference of two boundary rows.  Unlike ``index_add_``, which uses
atomics on CUDA, this is deterministic, so Krylov iteration counts are
reproducible from run to run.

Energy bookkeeping: with tensorial Voigt storage, sigma : eps(v) is formed by
contracting the full symmetric tensors, so no shear factor appears here.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

F32, F64 = torch.float32, torch.float64

# Voigt index of tensor entry (i, j), row-major over (i, j), tensorial
# order [xx, yy, zz, xy, xz, yz]
_T2V = [0, 3, 4, 3, 1, 5, 4, 5, 2]


@dataclass(frozen=True)
class ScatterPlan:
    """Destination-sorted CSR of the 4E element-node contributions.

    ``perm[k] = a * E + e`` is the k-th contribution in node order; node n
    owns ``perm[starts[n]:ends[n]]``.
    """
    perm: torch.Tensor      # (4E,) int64
    starts: torch.Tensor    # (N,) int64
    ends: torch.Tensor      # (N,) int64

    @staticmethod
    def build(conn: np.ndarray, n_nodes: int, device) -> "ScatterPlan":
        flat = np.asarray(conn).T.reshape(-1)                     # a-major
        return ScatterPlan.from_keys(flat, n_nodes, device)

    @staticmethod
    def from_keys(keys: np.ndarray, n_bins: int, device) -> "ScatterPlan":
        """Plan summing contribution k into bin ``keys[k]``."""
        perm = np.argsort(keys, kind="stable")
        keys_sorted = np.asarray(keys)[perm]
        bins = np.arange(n_bins)
        starts = np.searchsorted(keys_sorted, bins)
        ends = np.searchsorted(keys_sorted, bins, side="right")
        as_t = lambda x: torch.as_tensor(x.astype(np.int64),  # noqa: E731
                                         device=device)
        return ScatterPlan(as_t(perm), as_t(starts), as_t(ends))


def gather_u(u, conn):
    """u (N, 3) at element nodes, stacked (4, 3, E)."""
    return u[conn].permute(1, 2, 0)


def strain_stacked(ue_s, gN):
    """Voigt strain (6, E) from stacked element displacements (4, 3, E)."""
    grad = (ue_s[:, :, None, :] * gN[:, None, :, :]).sum(0)      # (3, 3, E)
    return torch.stack([grad[0, 0], grad[1, 1], grad[2, 2],
                        0.5 * (grad[0, 1] + grad[1, 0]),
                        0.5 * (grad[0, 2] + grad[2, 0]),
                        0.5 * (grad[1, 2] + grad[2, 1])])


def forces_stacked(sv_s, gN, vol=None):
    """Element nodal forces (4, 3, E) from Voigt stress (6, E); ``vol``
    multiplies in the element volume (None when it is folded into sv).
    The rows are stacked from views: indexing with the list would copy an
    index tensor from the host on every call."""
    sig = torch.stack([sv_s[k] for k in _T2V]).reshape(3, 3, -1)  # (3, 3, E)
    fe = (sig[None] * gN[:, None, :, :]).sum(2)                   # (4, 3, E)
    return fe if vol is None else fe * vol


def segment_sum(flat, plan: ScatterPlan):
    """(C, K) contributions -> (C, n_bins) bin sums by the cumsum plan.  The
    prefix sum runs along the contiguous axis: on CUDA a scan along the
    outer axis of a (K, C) array is ~60x slower."""
    cs = torch.cumsum(flat[:, plan.perm], dim=1)
    cs = torch.cat([torch.zeros((cs.shape[0], 1), dtype=cs.dtype,
                                device=cs.device), cs], dim=1)
    return cs[:, plan.ends] - cs[:, plan.starts]


def scatter(fe_s, plan: ScatterPlan):
    """Assemble nodal forces (N, 3) from stacked (4, 3, E) contributions by
    the cumsum plan."""
    flat = fe_s.permute(1, 0, 2).reshape(3, -1)                   # a-major
    return segment_sum(flat, plan).T.contiguous()


class MomentumKernel:
    """Vector CG1 elasticity operator pieces for one mesh on one device."""

    def __init__(self, grid, device):
        self.grid = grid
        self.device = torch.device(device)
        self.n_nodes = grid.n_nodes
        self.n_elems = grid.n_elems
        # host copies for the preconditioner builds
        self.conn_np = np.asarray(grid.conn, dtype=np.int64)
        self.grad_N = np.asarray(grid.grad_N)                     # (E, 4, 3)
        self.vol = np.asarray(grid.volumes)                       # (E,)
        self.conn = torch.as_tensor(self.conn_np, device=self.device)
        gN_s = np.ascontiguousarray(np.moveaxis(self.grad_N, 0, -1))
        self._gN = {F64: torch.as_tensor(gN_s, device=self.device)}
        self._gN[F32] = self._gN[F64].to(F32)
        self._vol = {F64: torch.as_tensor(self.vol, device=self.device)}
        self._vol[F32] = self._vol[F64].to(F32)
        self.plan = ScatterPlan.build(grid.conn, grid.n_nodes, self.device)
        self.band = None          # optional CUDA band operator (f32 path)
        self.dia = None           # optional assembled block-DIA operator

    def enable_band(self):
        """Route the f32 Krylov stiffness action through the hand-written
        band kernel (fem/bandkernel.py)."""
        from .bandkernel import BandMatvec
        self.band = BandMatvec(self)
        return self.band

    def enable_dia(self, max_offsets: int = 96, min_fill: float = 0.4):
        """Route the Krylov stiffness action through the assembled block-DIA
        operator (fem/dia.py, hand-written CUDA matvec).  Raises ValueError
        when the node numbering is not offset-structured; natural-order
        GridBox numberings qualify with 15 offsets."""
        from .dia import BlockDIA
        self.dia = BlockDIA(self, max_offsets=max_offsets, min_fill=min_fill)
        return self.dia

    def geom(self, dtype):
        """(grad_N (4, 3, E), vol (E,)) in ``dtype``."""
        return self._gN[dtype], self._vol[dtype]

    # ------------------------------------------------------------------ #
    def prep(self, CT: torch.Tensor) -> torch.Tensor:
        """CT (E, 6, 6) -> contiguous (6, 6, E), once per linear solve.
        Idempotent."""
        if CT.shape == (6, 6, self.n_elems):
            return CT
        return CT.permute(1, 2, 0).contiguous()

    @staticmethod
    def apply66(M_soa, v):
        """(E, 6) result of the batched apply M @ v, M in (6, 6, E)."""
        return (M_soa * v.T[None]).sum(1).T

    def strain(self, u: torch.Tensor) -> torch.Tensor:
        """Total strain eps(u) on DG0, Voigt (E, 6) (exact for P1 u)."""
        gN, _ = self.geom(u.dtype)
        return strain_stacked(gather_u(u, self.conn), gN).T

    def internal_force(self, sigma_v: torch.Tensor) -> torch.Tensor:
        """Nodal forces f_ai = V sigma_ij dN_a/dx_j, (N, 3)."""
        gN, vol = self.geom(sigma_v.dtype)
        return scatter(forces_stacked(sigma_v.T, gN, vol), self.plan)

    def matvec(self, CT_soa, u: torch.Tensor) -> torch.Tensor:
        """Stiffness action A(CT) @ u without boundary conditions; CT_soa
        from :meth:`prep`."""
        gN, vol = self.geom(u.dtype)
        ev = strain_stacked(gather_u(u, self.conn), gN)           # (6, E)
        sv = (CT_soa * ev[None]).sum(1)                           # (6, E)
        return scatter(forces_stacked(sv, gN, vol), self.plan)

    def body_force(self, density, g_vec) -> torch.Tensor:
        """int rho g . v dx with DG0 rho, P1 v: V rho g / 4 to each node."""
        g_vec = np.asarray(g_vec, dtype=np.float64)
        f_e = (np.asarray(density) * self.vol / 4.0)[:, None] * g_vec[None]
        f = np.repeat(f_e[:, None, :], 4, axis=1).reshape(-1, 3)
        out = np.zeros((self.n_nodes, 3))
        np.add.at(out, self.conn_np.reshape(-1), f)
        return torch.as_tensor(out, device=self.device)

    # -- host assembly for the preconditioners ---------------------------- #
    def element_stiffness(self, C) -> np.ndarray:
        """Per-element 12x12 stiffness blocks (E, 4, 3, 4, 3), f64, host."""
        g = self.grad_N
        E3 = np.eye(3)
        gi = g[:, :, None, :]
        ei = E3[None, None, :, :]
        xx = ei[..., 0] * gi[..., 0]
        yy = ei[..., 1] * gi[..., 1]
        zz = ei[..., 2] * gi[..., 2]
        xy = 0.5 * (ei[..., 0] * gi[..., 1] + ei[..., 1] * gi[..., 0])
        xz = 0.5 * (ei[..., 0] * gi[..., 2] + ei[..., 2] * gi[..., 0])
        yz = 0.5 * (ei[..., 1] * gi[..., 2] + ei[..., 2] * gi[..., 1])
        eps6 = np.stack([xx, yy, zz, xy, xz, yz], axis=-1)        # (E,4,3,6)
        w = np.asarray([1., 1., 1., 2., 2., 2.])
        sig6 = np.einsum("ekl,ebjl->ebjk", np.asarray(C), eps6)
        return np.einsum("ebjk,eaik,k,e->eaibj", sig6, eps6, w, self.vol)

    def block_diagonal(self, C) -> np.ndarray:
        """Nodal 3x3 diagonal blocks of A(C) (N, 3, 3), f64, host."""
        Ke = self.element_stiffness(C)
        blk = np.einsum("eaiaj->eaij", Ke)
        out = np.zeros((self.n_nodes, 3, 3))
        np.add.at(out, self.conn_np.reshape(-1), blk.reshape(-1, 3, 3))
        return out
