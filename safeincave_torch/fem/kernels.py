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

``HeatKernel`` holds the scalar P1 mass and stiffness actions of the implicit
heat step, with the closed-form tetrahedron integrals of the JAX package:
consistent mass M_ab = V (1 + delta_ab) / 20 and stiffness
K_ab = k V grad N_a . grad N_b.  Its node sums go through a
:class:`NodeGather` and not the cumsum plan: a prefix sum over all 4E
contributions loses about N eps of relative precision, which float32 (the
heat solve's Krylov operator) cannot afford.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import padded_bins

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


def element_stiffness(grad_N, vol, C) -> np.ndarray:
    """Per-element 12x12 stiffness blocks (E, 4, 3, 4, 3), f64, host, of
    the geometry ``grad_N`` (E, 4, 3), ``vol`` (E,) and tangents C
    (E, 6, 6)."""
    E3 = np.eye(3)
    gi = np.asarray(grad_N)[:, :, None, :]
    ei = E3[None, None, :, :]
    xx = ei[..., 0] * gi[..., 0]
    yy = ei[..., 1] * gi[..., 1]
    zz = ei[..., 2] * gi[..., 2]
    xy = 0.5 * (ei[..., 0] * gi[..., 1] + ei[..., 1] * gi[..., 0])
    xz = 0.5 * (ei[..., 0] * gi[..., 2] + ei[..., 2] * gi[..., 0])
    yz = 0.5 * (ei[..., 1] * gi[..., 2] + ei[..., 2] * gi[..., 1])
    eps6 = np.stack([xx, yy, zz, xy, xz, yz], axis=-1)            # (E,4,3,6)
    w = np.asarray([1., 1., 1., 2., 2., 2.])
    sig6 = np.einsum("ekl,ebjl->ebjk", np.asarray(C), eps6)
    return np.einsum("ebjk,eaik,k,e->eaibj", sig6, eps6, w, np.asarray(vol))


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


class RankOps:
    """The element layout of a kernel over the ranks of a multi-card run,
    and the reductions across them.

    An element-sharded kernel (parallel/sharding.py) pads ``n_elems_orig``
    elements by ``n_pad`` to ``n_elems_padded`` and holds the rank's block
    ``block`` of them; ``comm`` is the process group
    (:mod:`~safeincave_torch.parallel.dist`) and ``world`` its size.  With
    ``comm`` None (every element on this device, as on the unsharded
    kernels) each method is the identity."""

    comm = None
    world = 1
    block = slice(None)

    def local(self, arr):
        """This rank's block of a padded element array."""
        return arr if self.world == 1 else arr[self.block]

    def gather_elems(self, x):
        """The padded element array whose rank blocks are ``x`` (a tensor
        or a numpy array, returned as the same), gathered from every
        rank."""
        if self.comm is None or self.world == 1:
            return x
        if isinstance(x, torch.Tensor):
            return self.comm.all_gather(x)
        return self.comm.all_gather(
            torch.as_tensor(x, device=self.comm.device)).cpu().numpy()

    def global_sum(self, t):
        """The sum over the ranks of ``t``, a partial reduction over this
        rank's share."""
        return t if self.comm is None else self.comm.allreduce_sum(t)

    def global_max(self, t):
        """The maximum over the ranks of ``t``."""
        return t if self.comm is None else self.comm.allreduce_max(t)

    def from_rank0(self, build):
        """``build()``, a tuple of tensors and picklable values, made on
        rank 0 alone and sent to every rank, so that what is built once
        from the whole mesh holds the same bits everywhere."""
        if self.comm is None or self.world == 1:
            return build()
        return self.comm.from_rank0(build)


class MomentumKernel(RankOps):
    """Vector CG1 elasticity operator pieces for one mesh on one device."""

    def __init__(self, grid, device):
        self.grid = grid
        self.device = torch.device(device)
        self.n_nodes = grid.n_nodes
        self.n_elems = self.n_elems_orig = self.n_elems_padded = grid.n_elems
        self.n_pad = 0
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
        self.blockell = None      # optional assembled block-ELL operator
        self._node_gather = None  # node sums of (E, 4) contributions

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

    def enable_blockell(self, G: int = 8):
        """Route the Krylov stiffness action (both precisions) through the
        assembled block-ELL operator (fem/blockell.py).  Works with any
        node ordering; a locality-preserving one keeps K, the neighbour
        groups per group, small.  Raises ValueError when the f64 block
        tensor would pass 4 GiB."""
        from .blockell import BlockELL
        bell = BlockELL(self, G=G)
        budget = 4 << 30
        if bell.plan.nbytes(8) > budget:
            raise ValueError(
                f"block-ELL plan needs {bell.plan.nbytes(8) / 2**30:.1f} GiB "
                f"(K={bell.plan.K} neighbour groups at G={G}); the mesh is "
                f"not locality-ordered - rebuild the grid with "
                f"reorder='band' (or 'morton') before enable_blockell")
        self.blockell = bell
        return self.blockell

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

    def diagonal(self, CT: torch.Tensor) -> torch.Tensor:
        """diag(A(CT)) as (N, 3), for CT (E, 6, 6): per element and node the
        energy of the unit-displacement strain basis, summed over each
        node's elements through a :class:`NodeGather` (deterministic)."""
        dt = CT.dtype
        gN, vol = self.geom(dt)                                   # (4,3,E)
        g = gN.permute(2, 0, 1)                                   # (E,4,3)
        z = torch.zeros_like(g[..., 0])
        h = 0.5 * g
        # eps6[e, a, i, :]: strain of a unit displacement of node a along i
        eps6 = torch.stack([
            torch.stack([g[..., 0], z, z, h[..., 1], h[..., 2], z], -1),
            torch.stack([z, g[..., 1], z, h[..., 0], z, h[..., 2]], -1),
            torch.stack([z, z, g[..., 2], z, h[..., 0], h[..., 1]], -1),
        ], dim=2)                                                 # (E,4,3,6)
        sig6 = torch.einsum("ekl,eail->eaik", CT, eps6)
        w = torch.tensor([1., 1., 1., 2., 2., 2.], dtype=dt,
                         device=self.device)
        d_e = (sig6 * eps6 * w).sum(-1) * vol[:, None, None]      # (E,4,3)
        if self._node_gather is None:
            self._node_gather = NodeGather.build(
                self.conn_np.reshape(-1), self.n_nodes, self.device)
        return torch.stack([self._node_gather.sum(d_e[..., i])
                            for i in range(3)], dim=1)

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
        return element_stiffness(self.grad_N, self.vol, C)

    def block_diagonal(self, C) -> np.ndarray:
        """Nodal 3x3 diagonal blocks of A(C) (N, 3, 3), f64, host."""
        Ke = self.element_stiffness(C)
        blk = np.einsum("eaiaj->eaij", Ke)
        out = np.zeros((self.n_nodes, 3, 3))
        np.add.at(out, self.conn_np.reshape(-1), blk.reshape(-1, 3, 3))
        return out


@dataclass(frozen=True)
class NodeGather:
    """Node-major padded table of the contributions each bin sums.

    Row n of ``idx`` (n_bins, K) lists the flat indices of bin n's
    contributions in ascending order, K the largest count, padded with the
    index one past the last contribution (where :meth:`sum` puts a zero).
    A gather and a row reduction: deterministic on CUDA, where
    ``index_add_`` is atomic, and each sum has at most K terms."""
    idx: torch.Tensor       # (n_bins, K) int64
    n_contrib: int

    @staticmethod
    def build(keys: np.ndarray, n_bins: int, device) -> "NodeGather":
        """Table summing contribution k into bin ``keys[k]``."""
        idx = padded_bins(keys, n_bins)
        return NodeGather(torch.as_tensor(idx, device=device),
                          int(np.size(keys)))

    def sum(self, contrib: torch.Tensor, tail=()) -> torch.Tensor:
        """(n_bins, *tail) sums of the contributions (n_contrib, *tail)."""
        flat = contrib.reshape((self.n_contrib, *tail))
        flat = torch.cat([flat, flat.new_zeros((1, *tail))])
        return flat[self.idx].sum(1)


class HeatKernel(RankOps):
    """Scalar P1 heat operator pieces for one mesh on one device; every
    method computes in the dtype of the field (or coefficient) it is
    given."""

    def __init__(self, grid, device):
        self.grid = grid
        self.device = torch.device(device)
        self.n_nodes = grid.n_nodes
        self.n_elems = self.n_elems_orig = self.n_elems_padded = grid.n_elems
        self.n_pad = 0
        conn = np.asarray(grid.conn, dtype=np.int64)
        self.conn = torch.as_tensor(conn, device=self.device)
        gN = torch.as_tensor(np.asarray(grid.grad_N), device=self.device)
        vol = torch.as_tensor(np.asarray(grid.volumes), device=self.device)
        self._gN = {F64: gN, F32: gN.to(F32)}                     # (E, 4, 3)
        self._vol = {F64: vol, F32: vol.to(F32)}                  # (E,)
        self.gather = NodeGather.build(conn.reshape(-1), grid.n_nodes,
                                       self.device)

    def mass_apply(self, coef: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
        """(coef T, v) with DG0 coef, P1 T and v."""
        cv = coef.to(T.dtype) * self._vol[T.dtype]
        T_e = T[self.conn]                                        # (E, 4)
        m = (T_e + T_e.sum(1, keepdim=True)) * (cv / 20.0)[:, None]
        return self.gather.sum(m)

    def stiffness_apply(self, k: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
        """(k grad T, grad v) with DG0 conductivity."""
        gN = self._gN[T.dtype]
        kv = k.to(T.dtype) * self._vol[T.dtype]
        gT = (T[self.conn][:, :, None] * gN).sum(1)               # (E, 3)
        f = (gT[:, None, :] * gN).sum(2) * kv[:, None]            # (E, 4)
        return self.gather.sum(f)

    def factors(self, coef: torch.Tensor, k: torch.Tensor):
        """The per-element factors of :meth:`apply` in the dtype of
        ``coef``: (coef vol / 20, k vol)."""
        vol = self._vol[coef.dtype]
        return (coef * vol) / 20.0, k.to(coef.dtype) * vol

    def apply(self, cv20: torch.Tensor, kv: torch.Tensor,
              T: torch.Tensor) -> torch.Tensor:
        """``mass_apply(coef, T) + stiffness_apply(k, T)`` bit for bit,
        from :meth:`factors` made once per step, with the corner values
        gathered once: fewer kernels per application."""
        T_e = T[self.conn]                                        # (E, 4)
        m = (T_e + T_e.sum(1, keepdim=True)) * cv20[:, None]
        gN = self._gN[T.dtype]
        gT = (T_e[:, :, None] * gN).sum(1)                        # (E, 3)
        f = (gT[:, None, :] * gN).sum(2) * kv[:, None]            # (E, 4)
        return self.gather.sum(m) + self.gather.sum(f)

    def mass_diagonal(self, coef: torch.Tensor) -> torch.Tensor:
        d = (coef * self._vol[coef.dtype] * (2.0 / 20.0))[:, None]
        return self.gather.sum(d.expand(-1, 4))

    def stiffness_diagonal(self, k: torch.Tensor) -> torch.Tensor:
        gN = self._gN[k.dtype]
        d = (gN * gN).sum(2) * (k * self._vol[k.dtype])[:, None]
        return self.gather.sum(d)

    def nodes_to_elems(self, T: torch.Tensor) -> torch.Tensor:
        """DG0 projection of a P1 field: the vertex average."""
        return T[self.conn].mean(1)
