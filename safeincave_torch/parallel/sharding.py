"""Element-sharded execution over a part mesh (port of
``safeincave_tpu/parallel/sharding.py``).

The JAX package shards every per-element array over the devices of a mesh
axis: the constitutive update runs per shard without communication, each
shard scatter-adds its element contributions into a full nodal vector and a
``psum`` over the axis assembles them (the reference's PETSc ghost updates).

The port runs the same D-part computation on W ranks, one device each
(W = 1 without a process group): element arrays are padded to a multiple of
D exactly as the JAX package pads them, the parts are D contiguous blocks of
E_pad / D elements, and rank r keeps parts [r D/W, (r+1) D/W), a contiguous
block of E_pad / W elements, stacked on a leading axis.  Each part sums its
contributions into its own nodal vector, the rank sums its parts, and an
all-reduce over the ranks (:mod:`~safeincave_torch.parallel.dist`) sums the
ranks: the ``psum``.  Nodal vectors are whole and the same bits on every
rank; element arrays hold the rank's block.  A :class:`PartMesh` names the
parts, this rank's device and the process group.

Padded cells have zero volume, node 0 as every vertex and edge-replicated
gradients and material data, so their strain is zero, they add nothing to
forces, norms or rates, and their constitutive maths stays finite.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import default_device
from . import dist
from ..fem.kernels import (F32, F64, HeatKernel, NodeGather, RankOps,
                           element_stiffness)
from ..utils import pad_elem_array, tensor_to_voigt, voigt_to_tensor


@dataclass(frozen=True)
class PartMesh:
    """D parts of one decomposition axis over ``world`` ranks: the port's
    stand-in for a ``jax.sharding.Mesh``.  This rank holds parts
    [``first_part``, ``first_part + parts_per_rank``) on ``device``;
    ``comm`` is the process group (None: every part on this device)."""
    n_parts: int
    device: torch.device
    axis: str = "e"
    rank: int = 0
    world: int = 1
    comm: object = field(default=None, compare=False, repr=False)

    @property
    def parts_per_rank(self) -> int:
        return self.n_parts // self.world

    @property
    def first_part(self) -> int:
        return self.rank * self.parts_per_rank


def _same_device(a, b) -> bool:
    """Whether two devices are one, ``cuda`` meaning the current card."""
    a, b = torch.device(a), torch.device(b)
    if a.type == "cuda" and a.index is None:
        a = torch.device("cuda", torch.cuda.current_device())
    if b.type == "cuda" and b.index is None:
        b = torch.device("cuda", torch.cuda.current_device())
    return a == b


def make_device_mesh(n_parts: int | None = None, device=None,
                     axis: str = "e", comm=None,
                     stacked: bool = False) -> PartMesh:
    """A :class:`PartMesh` of ``n_parts`` parts.

    In a multi-card run (``comm``, default the communicator of
    :func:`~safeincave_torch.parallel.dist.init_parts`) the parts are split
    over the ranks, ``n_parts`` defaults to the world size (one part per
    card, as the JAX package defaults to all devices) and must be a
    multiple of it, and ``device`` is this rank's card.  Without a process
    group, or with ``stacked=True``, every part lives on ``device``
    (default :func:`~safeincave_torch.default_device`: the card; it raises
    without one, naming ``device="cpu"``), and ``n_parts`` defaults to the
    number of visible CUDA devices."""
    if comm is None and not stacked:
        comm = dist.current()
    if comm is not None:
        if device is not None and not _same_device(device, comm.device):
            raise ValueError(f"make_device_mesh: rank {comm.rank} runs on "
                             f"{comm.device}, not {device}")
        device, rank, world = comm.device, comm.rank, comm.world
        if n_parts is None:
            n_parts = world
    else:
        device = torch.device(device) if device is not None \
            else default_device()
        rank, world = 0, 1
        if n_parts is None:
            n_parts = torch.cuda.device_count()
    if n_parts < 1:
        raise ValueError(f"make_device_mesh: {n_parts} parts; give n_parts "
                         f"(no CUDA device is visible)")
    if n_parts % world:
        raise ValueError(f"make_device_mesh: {n_parts} parts do not split "
                         f"over {world} ranks; give a multiple of {world}")
    return PartMesh(int(n_parts), device, axis, rank, world, comm)


class _PartSums:
    """Node sums of element contributions (E_loc, 4, *tail), E_loc the
    rank's block, with a :class:`NodeGather`'s ``sum``: each of the rank's
    D_loc parts (a block of E_loc / D_loc elements) sums its own into bins
    d * n_nodes + node, deterministically, the parts are summed, then the
    ranks (the ``psum``)."""

    def __init__(self, conn_np, D, n_nodes, device, comm=None):
        part = np.repeat(np.arange(D), conn_np.shape[0] // D)[:, None]
        keys = part * n_nodes + conn_np
        self._gather = NodeGather.build(keys.reshape(-1), D * n_nodes,
                                        device)
        self.D, self.n_nodes, self.comm = D, n_nodes, comm

    def sum(self, contrib, tail=()):
        per_part = self._gather.sum(contrib, tail)
        out = per_part.reshape((self.D, self.n_nodes, *tail)).sum(0)
        return out if self.comm is None else self.comm.allreduce_sum(out)


class _ShardedGeometry(RankOps):
    """Padded element geometry of one grid over a part mesh: the host
    arrays (for the preconditioner builds) whole, the device tensors this
    rank's block ``block`` of ``n_elems`` elements."""

    def __init__(self, grid, mesh: PartMesh, axis: str = "e"):
        self.grid = grid
        self.mesh = mesh
        self.axis = axis
        self.device = mesh.device
        self.comm, self.world = mesh.comm, mesh.world
        D = self.D = mesh.n_parts
        E = grid.n_elems
        self.n_elems_orig = E
        self.n_pad = (-E) % D
        self.n_elems_padded = E + self.n_pad
        n_blk = self.n_elems_padded // mesh.world
        self.n_elems = n_blk
        self.block = slice(mesh.rank * n_blk, (mesh.rank + 1) * n_blk)
        self.n_nodes = grid.n_nodes
        # padded cells: conn -> node 0, grad_N edge-replicated (rows sum to
        # zero, so the padded strain is 0), volume 0
        self.conn_np = pad_elem_array(np.asarray(grid.conn, dtype=np.int64),
                                      self.n_pad, mode="zero")
        self.grad_N = pad_elem_array(np.asarray(grid.grad_N), self.n_pad)
        self.vol = pad_elem_array(np.asarray(grid.volumes), self.n_pad,
                                  mode="zero")
        dev = self.device
        conn_blk = self.local(self.conn_np)
        self.conn = torch.as_tensor(conn_blk, device=dev)
        gN = torch.as_tensor(self.local(self.grad_N), device=dev)
        vol = torch.as_tensor(self.local(self.vol), device=dev)
        self._gN = {F64: gN, F32: gN.to(F32)}                     # (E, 4, 3)
        self._vol = {F64: vol, F32: vol.to(F32)}                  # (E,)
        self.gather = _PartSums(conn_blk, mesh.parts_per_rank, self.n_nodes,
                                dev, self.comm)


class ShardedMomentumKernel(_ShardedGeometry):
    """Counterpart of :class:`~safeincave_torch.fem.kernels.MomentumKernel`
    whose assemblies are per-part sums followed by the sum over the parts
    and the ranks.  Element arrays in and out are the rank's block; nodal
    vectors are whole.  ``global_sum``, ``global_max``, ``gather_elems``
    and ``from_rank0`` (:class:`~safeincave_torch.fem.kernels.RankOps`)
    carry reductions, element fields and the whole-mesh preconditioner
    builds across the ranks (on :class:`MomentumKernel` they are the
    identity).
    Tangents stay in the (E, 6, 6) layout (``prep`` is the identity), and
    no assembled or hand-written operator is attached, so the solver takes
    ``matvec`` for both precisions."""

    band = dia = blockell = None

    # -- MomentumKernel API -------------------------------------------- #
    @staticmethod
    def prep(CT):
        """The identity: the psum assembly keeps the (E, 6, 6) layout."""
        return CT

    @staticmethod
    def apply66(M, v):
        """(E, 6) batched apply M @ v, M in (E, 6, 6)."""
        return torch.einsum("nij,nj->ni", M, v)

    def geom(self, dtype):
        """(grad_N (E, 4, 3), vol (E,)) in ``dtype``."""
        return self._gN[dtype], self._vol[dtype]

    def strain(self, u):
        gN, _ = self.geom(u.dtype)
        grad_u = torch.einsum("eai,eaj->eij", u[self.conn], gN)
        return tensor_to_voigt(0.5 * (grad_u + grad_u.transpose(-1, -2)))

    def internal_force(self, sigma_v):
        gN, vol = self.geom(sigma_v.dtype)
        f_e = torch.einsum("eij,eaj,e->eai", voigt_to_tensor(sigma_v), gN,
                           vol)
        return self.gather.sum(f_e, (3,))

    def matvec(self, CT, u):
        return self.internal_force(self.apply66(CT, self.strain(u)))

    def _eps6(self, dtype):
        """Strain of each unit nodal displacement, (E, 4, 3, 6)."""
        gN, _ = self.geom(dtype)
        gi = gN[:, :, None, :]
        ei = torch.eye(3, dtype=dtype, device=self.device)
        return torch.stack([
            ei[:, 0] * gi[..., 0], ei[:, 1] * gi[..., 1],
            ei[:, 2] * gi[..., 2],
            0.5 * (ei[:, 0] * gi[..., 1] + ei[:, 1] * gi[..., 0]),
            0.5 * (ei[:, 0] * gi[..., 2] + ei[:, 2] * gi[..., 0]),
            0.5 * (ei[:, 1] * gi[..., 2] + ei[:, 2] * gi[..., 1])], -1)

    def diagonal(self, CT):
        """diag(A(CT)) as (N, 3)."""
        CT = torch.as_tensor(CT, device=self.device)
        eps6 = self._eps6(CT.dtype)
        _, vol = self.geom(CT.dtype)
        sig6 = torch.einsum("ekl,eail->eaik", CT, eps6)
        w = torch.tensor([1., 1., 1., 2., 2., 2.], dtype=CT.dtype,
                         device=self.device)
        d_e = torch.einsum("eaik,eaik,k,e->eai", sig6, eps6, w, vol)
        return self.gather.sum(d_e, (3,))

    def block_diagonal(self, C):
        """Nodal 3x3 diagonal blocks of A(C) (N, 3, 3), f64, on the
        device, of the whole padded C (its rank block is used)."""
        C = torch.as_tensor(self.local(C), dtype=F64, device=self.device)
        eps6 = self._eps6(F64)
        _, vol = self.geom(F64)
        sig6 = torch.einsum("ekl,eajl->eajk", C, eps6)
        w = torch.tensor([1., 1., 1., 2., 2., 2.], dtype=F64,
                         device=self.device)
        blk = torch.einsum("eajk,eaik,k,e->eaij", sig6, eps6, w, vol)
        return self.gather.sum(blk, (3, 3))

    def body_force(self, density, g_vec):
        """int rho g . v dx with DG0 rho: V rho g / 4 to each node."""
        rho = torch.as_tensor(np.asarray(density, dtype=np.float64),
                              device=self.device)
        g = torch.as_tensor(np.asarray(g_vec, dtype=np.float64),
                            device=self.device)
        f_e = (rho * self._vol[F64] / 4.0)[:, None] * g[None]
        return self.gather.sum(f_e[:, None, :].expand(-1, 4, 3), (3,))

    # -- host assembly for the preconditioners ---------------------------- #
    def element_stiffness(self, C) -> np.ndarray:
        """Per-element 12x12 stiffness blocks (E_pad, 4, 3, 4, 3), f64,
        host, of the whole padded C; zero on padded cells."""
        return element_stiffness(self.grad_N, self.vol, C)


class ShardedHeatKernel(_ShardedGeometry, HeatKernel):
    """Counterpart of :class:`~safeincave_torch.fem.kernels.HeatKernel`:
    its operators on the padded geometry, with per-part node sums and the
    sum over the parts.  Nodal temperature stays whole; the DG0 projection
    (``nodes_to_elems``) returns the padded element layout the sharded
    momentum equation reads."""


def _check_device(eq, mesh: PartMesh):
    if not _same_device(mesh.device, eq.device):
        raise ValueError(f"the part mesh is on {mesh.device}, the equation "
                         f"on {eq.device}")


def shard_tm(eq, heat, mesh: PartMesh | None = None, axis: str = "e",
             mode: str = "halo"):
    """Shard a coupled thermo-mechanical pair over a part mesh:
    :func:`shard_equation` for the momentum equation, the per-part heat
    assembly and the padded heat coefficients.  The port's heat equation
    caches nothing built on its kernel but its graphs, which setting the
    kernel drops (a part kernel runs uncaptured), so swapping the kernel
    and padding ``k``, ``rho`` and ``cp`` is all it needs."""
    if mesh is None:
        mesh = make_device_mesh(axis=axis)
    shard_equation(eq, mesh=mesh, axis=axis, mode=mode)
    kern = heat.kernel = ShardedHeatKernel(heat.grid, mesh, axis)
    heat.n_elems = kern.n_elems
    for name in ("k", "rho", "cp"):
        arr = getattr(heat, name)
        if arr.shape[0] == kern.n_elems_orig:
            arr = pad_elem_array(arr, kern.n_pad)
        setattr(heat, name, kern.local(arr))
    return eq, heat


def shard_equation(eq, mesh: PartMesh | None = None, axis: str = "e",
                   mode: str = "halo"):
    """Convert an assembled :class:`LinearMomentum` to part execution.

    Pads every per-element array (kernel geometry, material operators and
    parameters, element states, stress and strain fields) to a multiple of
    the part count, as the JAX package pads them, keeps this rank's block
    of it, and swaps in the :class:`ShardedMomentumKernel`.  What is built
    once per wiring from the whole mesh (the dense preconditioner, the
    two-level coarse space) is built on rank 0 from gathered arrays and
    broadcast.

    ``mode`` selects the linear solve's communication pattern:

    * ``"halo"`` (default): the Krylov loop runs on owner-blocked padded
      vectors with neighbour-only halo exchange per matvec
      (:class:`~safeincave_torch.parallel.halo.HaloMomentumSolver`), the
      layout converted once per solve;
    * ``"psum"``: each matvec sums every part's full nodal vector.
    """
    if mode not in ("halo", "psum"):
        raise ValueError(f"mode must be 'halo' or 'psum', got {mode!r}")
    if mesh is None:
        mesh = make_device_mesh(axis=axis)
    _check_device(eq, mesh)
    kern = ShardedMomentumKernel(eq.grid, mesh, axis)
    n_pad = kern.n_pad
    eq.kernel = kern
    eq.n_elems_orig = kern.n_elems_orig
    eq.n_elems = kern.n_elems

    def pad(arr, mode="edge"):
        return kern.local(pad_elem_array(arr, n_pad, mode))

    # zero stress and strain on padded cells: every constitutive model
    # guards the zero-stress state
    eq.sig_v = pad(eq.sig_v, "zero")
    eq.eps_tot_v = pad(eq.eps_tot_v, "zero")
    eq.eps_rhs_v = pad(eq.eps_rhs_v, "zero")
    eq.Temp = pad(eq.Temp)
    eq.T0 = pad(eq.T0)

    # material operators and parameters: edge-replicated, so the padded
    # constitutive maths stays finite; rebuilding the elastic tensors from
    # the padded host arrays also rebuilds their f32 shadows
    mat = eq.mat
    mat.n_elems = kern.n_elems
    for name in ("_C", "_C_inv", "_C_tilde", "_C_tilde_inv"):
        setattr(mat, name, pad(getattr(mat, name)))
    mat._set_elastic()
    if hasattr(mat, "density"):
        mat.density = pad(mat.density)
    for elem in mat.elems_ne:
        elem.n_elems = kern.n_elems
        elem.params = {k: pad(v) for k, v in elem.params.items()}
        elem.state = {k: pad(v) for k, v in elem.state.items()}
        if hasattr(elem, "C1"):
            elem.C1 = pad(elem.C1)
            elem._C1_32 = elem.C1.to(F32)
        # the f32 parameter shadow is made again from the padded params
        for cache in ("_params32", "_params32_of"):
            if hasattr(elem, cache):
                delattr(elem, cache)
    for elem in mat.elems_th:
        elem.n_elems = kern.n_elems
        elem.alpha = pad(elem.alpha)
        elem.eps_th_v = pad(elem.eps_th_v, "zero")
    for elem in mat.elems_e:
        elem.n_elems = kern.n_elems
        for name in ("E", "nu", "C", "C_inv", "C_tilde", "C_tilde_inv", "K"):
            setattr(elem, name, pad(getattr(elem, name)))

    if mode == "halo":
        from .halo import HaloMomentumSolver
        eq._halo = HaloMomentumSolver(eq.grid, mesh, axis=axis)
    else:
        eq._halo = None

    # what was built on the unsharded kernel: the preconditioner and the
    # linear solvers that close over it
    eq._precond = None
    eq._reset_solvers()
    return eq
