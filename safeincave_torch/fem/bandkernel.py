"""f32 band stiffness action: the hand-written CUDA kernel and its plain twin.

Port of ``safeincave_tpu/fem/bandkernel.py`` (``_band_kernel``, the Pallas
TPU kernel).  The CUDA source, ``csrc/band_matvec.cu``, says what it replaces,
what bounds it and how it is laid out; :class:`BandTilePlan` is the host
side of its two-level sum.  The wrapper launches it for CUDA tensors and
uses :func:`band_matvec_plain` only for CPU tensors; a CUDA tensor that the
kernel cannot take raises.

The tangent is packed once per linear solve with the element volume folded
in (``ctv = CT * vol``, (36, E) f32), as the TPU kernel does.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import tracing
from .kernels import (F32, ScatterPlan, forces_stacked, gather_u, scatter,
                      strain_stacked)

_SMS = 132          # streaming multiprocessors of an H100


def band_matvec_plain(ctv, gN, conn, plan: ScatterPlan, u):
    """Plain PyTorch element matvec: ctv (36, E), gN (12, E) with row
    ``a * 3 + i``, conn (E, 4), u (N, 3) -> (N, 3), assembled by the cumsum
    plan, in the dtype of the inputs."""
    E = ctv.shape[1]
    gN3 = gN.reshape(4, 3, E)
    ev = strain_stacked(gather_u(u, conn), gN3)                   # (6, E)
    sv = (ctv.reshape(6, 6, E) * ev[None]).sum(1)                 # (6, E)
    return scatter(forces_stacked(sv, gN3), plan)


def tile_size(n_elems: int) -> int:
    """Elements per tile: 256 where that gives at least two tiles (blocks)
    per SM, else 128."""
    return 256 if -(-n_elems // 256) >= 2 * _SMS else 128


class BandTilePlan:
    """The band kernel's two-level sum for one mesh (host numpy, built once).

    Elements are cut into tiles of ``T`` consecutive elements; in band order
    (elements sorted by their lowest RCM node) a tile touches few nodes.

    - ``tile_lo`` (n_tiles + 1,): local node ``l`` of tile ``t`` is
      ``tile_lo[t] <= l < tile_lo[t + 1]``, sorted by node id; ``lnode[l]``
      is its node.
    - ``corner`` (E, 4): local index (within its tile) of each element
      corner.
    - ``contrib`` (4 T n_tiles,): tile ``t``'s contributions
      ``4 e_local + a`` from position ``4 t T`` on, grouped by local node,
      in (element, corner) order within a node, zero after the last
      element (the kernel stages 4T per tile); local node ``l`` owns
      positions ``lend[l - 1]`` (0 for a tile's first) to ``lend[l]``,
      counted within the tile.
    - ``dst`` (n_local,): the partial slot to which pass 1 writes a local
      node's sum.
    - pass 2: node ``n`` sums ``partials[pstart[n]:pstart[n + 1]]``, one
      partial per tile that touches it, in tile order.
    """

    def __init__(self, conn: np.ndarray, n_nodes: int, T: int | None = None):
        conn = np.asarray(conn, dtype=np.int64)
        E, N = conn.shape[0], n_nodes
        T = tile_size(E) if T is None else T
        self.n_elems, self.n_nodes, self.T = E, N, T
        self.n_tiles = -(-E // T)
        k = np.arange(4 * E)                       # contribution 4 e + a
        node = conn.reshape(-1)
        tile = k // (4 * T)
        key, inv = np.unique(tile * N + node, return_inverse=True)
        inv = inv.reshape(-1)
        l_tile, self.lnode = key // N, key % N
        self.tile_lo = np.searchsorted(l_tile, np.arange(self.n_tiles + 1))
        self.corner = (inv - self.tile_lo[tile]).reshape(E, 4)
        order = np.lexsort((k, inv))               # by local node, then k
        self.contrib = np.zeros(4 * T * self.n_tiles, dtype=np.int64)
        self.contrib[:4 * E] = k[order] - 4 * T * tile[order]
        self.lend = np.cumsum(np.bincount(inv, minlength=len(key))) \
            - 4 * T * l_tile
        # partial slots: a node's partials contiguous, in tile order
        self.pstart = np.concatenate(
            [[0], np.cumsum(np.bincount(self.lnode, minlength=N))])
        by_node = np.lexsort((l_tile, self.lnode))
        rank = np.empty(len(key), dtype=np.int64)
        rank[by_node] = np.arange(len(key)) - self.pstart[self.lnode[by_node]]
        self.dst = self.pstart[self.lnode] + rank
        self.max_local = int(np.diff(self.tile_lo).max())


class _BandPlanC(ctypes.Structure):
    """Mirror of ``struct BandPlan`` in csrc/band_matvec.cu, field by
    field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "gn", "corner", "contrib", "tile_lo", "lnode", "dst", "lend",
        "pstart", "partials")] + [
        (name, ctypes.c_int) for name in (
            "n_elems", "n_nodes", "tile", "n_tiles", "max_local")]


class BandMatvec:
    """f32 stiffness action for one mesh, on the kernel's device.

    ``launches`` counts kernel launches (one per application of an
    :meth:`operator` on CUDA; each launch is an enqueue that ends a gap of
    :mod:`~safeincave_torch.tracing`).  Applications share one partial-sum
    buffer, so they run in the order of one stream."""

    def __init__(self, kern):
        self.n_nodes = kern.n_nodes
        self.n_elems = kern.n_elems
        self.device = kern.conn.device     # carries the CUDA index
        gN, vol = kern.geom(F32)
        self.gN = gN.reshape(12, self.n_elems).contiguous()
        self.vol = vol
        self.conn = kern.conn
        self.plan = kern.plan
        self._conn_np = kern.conn_np
        self.launches = 0
        self._plan_c = None     # the tile plan on the device, made on use

    def pack_ct(self, CT_soa32):
        """(6, 6, E) f32 tangent -> vol-folded (36, E) f32, once per solve."""
        return (CT_soa32 * self.vol).reshape(36, self.n_elems).contiguous()

    def matvec(self, ctv, u):
        """(N, 3) f32 -> (N, 3) f32.  A solver applies the same ``ctv``
        many times through :meth:`operator`."""
        return self.operator(ctv)(u)

    def _device_plan(self):
        """The mesh's tile plan, its tables on the device and the C struct
        pointing at them, made once."""
        if self._plan_c is None:
            tp, dev = BandTilePlan(self._conn_np, self.n_nodes), self.device
            as_dev = lambda x, dt: torch.as_tensor(  # noqa: E731
                np.ascontiguousarray(x).astype(dt), device=dev)
            self._tables = dict(
                corner=as_dev(tp.corner, np.int16),
                contrib=as_dev(tp.contrib, np.int16),
                tile_lo=as_dev(tp.tile_lo, np.int32),
                lnode=as_dev(tp.lnode, np.int32),
                dst=as_dev(tp.dst, np.int32),
                lend=as_dev(tp.lend, np.int16),
                pstart=as_dev(tp.pstart, np.int32),
                partials=torch.empty((len(tp.lnode), 3), dtype=F32,
                                     device=dev))
            ptrs = {k: v.data_ptr() for k, v in self._tables.items()}
            self._plan_c = _BandPlanC(
                gn=self.gN.data_ptr(), **ptrs, n_elems=self.n_elems,
                n_nodes=self.n_nodes, tile=tp.T, n_tiles=tp.n_tiles,
                max_local=tp.max_local)
        return self._plan_c

    def operator(self, ctv):
        """The action ``u -> A u`` of the packed tangent ``ctv`` (from
        :meth:`pack_ct`).  A CPU ``ctv`` gives the plain twin.  A CUDA
        ``ctv`` is checked here, once (device, dtype, shape, contiguity);
        each application checks ``u`` alone and launches the kernel."""
        E, N = self.n_elems, self.n_nodes
        if ctv.device.type == "cpu":
            def plain(u):
                if u.device.type != "cpu":
                    raise ValueError(f"band_matvec: u is on {u.device}, ctv "
                                     f"on cpu")
                return band_matvec_plain(ctv, self.gN, self.conn, self.plan,
                                         u)
            return plain
        from .. import _build
        if ctv.device != self.device or ctv.dtype != F32 or \
                tuple(ctv.shape) != (36, E) or not ctv.is_contiguous():
            raise ValueError(
                f"band_matvec: ctv must be a contiguous (36, {E}) float32 "
                f"tensor on {self.device}, got {tuple(ctv.shape)} "
                f"{ctv.dtype} on {ctv.device}")
        fn, check = _build.kernel("band_matvec", "band_matvec_f32")
        stream = _build.stream_query(self.device)
        dev, plan = self.device, ctypes.addressof(self._device_plan())

        def launch(u):
            if u.device != dev or u.dtype != F32 or u.shape != (N, 3) or \
                    not u.is_contiguous():
                raise ValueError(
                    f"band_matvec: u must be a contiguous ({N}, 3) float32 "
                    f"tensor on {dev}, got {tuple(u.shape)} {u.dtype} on "
                    f"{u.device}")
            f = torch.empty((N, 3), dtype=F32, device=dev)
            check(fn(plan, ctv.data_ptr(), u.data_ptr(), f.data_ptr(),
                     stream()))
            tracing.enqueue()
            self.launches += 1
            return f

        return launch
