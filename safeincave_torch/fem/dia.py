"""Assembled block-DIA (offset) stiffness operator and its CUDA matvec.

Port of ``safeincave_tpu/fem/dia.py``.  On a structured (lexicographic) node
numbering the column offsets ``j - i`` of all node pairs collapse to a few
values (15 for the GridBox Kuhn split), so the operator is stored as one
3x3 value plane per offset and the matvec is

    y[i, c] = sum_d sum_c' vals[9d + 3c + c', i] * u[i + off_d, c']

with no gather tables.  The f32 and f64 matvecs run the hand-written CUDA
kernel ``csrc/dia_matvec.cu`` for CUDA tensors; :func:`dia_matvec_plain`
serves CPU tensors.  A CUDA tensor that the kernel cannot take raises.

Assembly: on a recognised box lattice (:class:`StructuredPlan`) the element
block rows land as 96 static strided slice-adds; otherwise a
row-granular reduction keyed by (offset, node) runs through the
deterministic cumsum plan of ``fem/kernels.py`` (``index_add_`` is atomic
on CUDA, so its sums, and with them the Krylov counts, would not repeat).

Layout: planes ``(Dn*9, ld)``, node axis last, row ``9d + 3c + c'``, as in
the JAX package.  The node stride ``ld`` is N rounded up to a multiple of 4
(the JAX package rounds up to its 8,192-node TPU tile), so that the CUDA
kernel reads 4 nodes of a plane row as one 16-byte vector; the columns
``[N, ld)`` are zero.  Padding contract: slots of node pairs that do not
exist hold exact zeros, so reads of ``u`` outside ``[0, N)`` multiply zero
coefficients and are skipped.

:class:`DIAPlan` refuses meshes whose numbering is not offset-structured
(too many offsets or low slot fill); callers keep the cumsum operator then.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import tracing
from .blockell import element_block_comp_rows, element_block_rows
from .kernels import F32, F64, ScatterPlan, segment_sum


class DIAPlan:
    """Static offset tables for one mesh (host numpy, built once)."""

    def __init__(self, conn: np.ndarray, n_nodes: int,
                 max_offsets: int = 96, min_fill: float = 0.4):
        conn = np.asarray(conn, dtype=np.int64)
        E = conn.shape[0]
        self.n_nodes = n_nodes
        self.n_elems = E

        # contribution row r in (ab)-major layout: r = (4a + b) * E + e
        rows = np.arange(16 * E)
        a_r = (rows // E) // 4
        b_r = (rows // E) % 4
        e_r = rows % E
        i_r = conn[e_r, a_r]
        j_r = conn[e_r, b_r]
        d_r = j_r - i_r

        offsets = np.unique(d_r)
        n_pairs = len(np.unique(i_r * (2 * n_nodes + 1) + d_r))
        fill = n_pairs / (len(offsets) * n_nodes)
        if len(offsets) > max_offsets or fill < min_fill:
            raise ValueError(
                f"node numbering is not offset-structured: {len(offsets)} "
                f"distinct column offsets at {fill:.2f} slot fill (need "
                f"<= {max_offsets} at >= {min_fill}); keep the band/cumsum "
                f"kernels for this mesh")
        self.offsets = offsets.astype(np.int64)          # sorted
        self.Dn = len(offsets)
        self.fill = fill
        self.n_pairs = n_pairs
        d_idx = np.searchsorted(offsets, d_r)
        self.row_slot = (d_idx * n_nodes + i_r).astype(np.int32)  # (16E,)


class StructuredPlan:
    """(tet-type, a, b) -> (offset plane, lattice shift) table.

    Inferred from the connectivity alone: holds exactly when the mesh is a
    natural-order cell-major box split into a fixed per-cell tet pattern
    sharing one base corner (the GridBox Kuhn split).  Every (t, a, b)
    combo then contributes to one offset plane at one constant (di, dj, dk)
    lattice shift.
    """

    def __init__(self, conn: np.ndarray, n_nodes: int,
                 offsets: np.ndarray):
        conn = np.asarray(conn, dtype=np.int64)
        E = conn.shape[0]
        if E % 6 != 0:
            raise ValueError("not a 6-tets-per-cell mesh")
        H = E // 6
        base = conn[0::6, 0]                      # cell base corner ids
        # per (t, a): node = base + delta[t, a] for all cells, else refuse
        delta = np.empty((6, 4), dtype=np.int64)
        for t in range(6):
            for a in range(4):
                d = conn[t::6, a] - base
                if d.min() != d.max():
                    raise ValueError("cell-node shifts are not constant")
                delta[t, a] = d[0]
        # recover the lattice dims from the base-id run structure
        steps = np.diff(base)
        if H > 1 and steps.min() < 1:
            raise ValueError("cells are not lexicographic")
        nz = int(np.argmax(steps != 1)) + 1 if (steps != 1).any() else H
        if H % nz:
            raise ValueError("cells are not lexicographic")
        rem = H // nz
        ok = None
        for ny in range(1, rem + 1):
            if rem % ny:
                continue
            nx = rem // ny
            sy = nz + 1
            sx = (ny + 1) * (nz + 1)
            I, J, K = np.meshgrid(np.arange(nx), np.arange(ny),
                                  np.arange(nz), indexing="ij")
            expect = (I.ravel() * (ny + 1) + J.ravel()) * (nz + 1) + K.ravel()
            if np.array_equal(base, expect):
                ok = (nx, ny, nz, sx, sy)
                break
        if ok is None:
            raise ValueError("cell bases do not form a box lattice")
        self.nx, self.ny, self.nz, sx, sy = ok
        if n_nodes != (self.nx + 1) * (self.ny + 1) * (self.nz + 1):
            raise ValueError("node count does not match the lattice")
        # decode per-(t, a) corner shifts (di, dj, dk) in {0, 1}
        corner = np.empty((6, 4, 3), dtype=np.int64)
        for t in range(6):
            for a in range(4):
                d = delta[t, a]
                di, r = divmod(d, sx)
                dj, dk = divmod(r, sy)
                if not (0 <= di <= 1 and 0 <= dj <= 1 and 0 <= dk <= 1):
                    raise ValueError("cell shift is not a unit corner")
                corner[t, a] = (di, dj, dk)
        # (t, a, b) -> (d_idx, target corner of a)
        off_list = offsets.tolist()
        self.table = []
        for t in range(6):
            for a in range(4):
                for b in range(4):
                    d = int(delta[t, b] - delta[t, a])
                    self.table.append((t, a, b, off_list.index(d),
                                       tuple(int(x) for x in corner[t, a])))


def dia_matvec_plain(vals, u, offsets, n_nodes):
    """Plain PyTorch block-DIA matvec (port of the XLA loop of
    ``BlockDIA.matvec``): vals (Dn*9, >= N; padding columns are ignored),
    u (N, 3) -> (N, 3), reads of u outside [0, N) are zero.  Sums over d,
    then c' for each component c."""
    N = n_nodes
    vals = vals[:, :N]
    offsets = [int(o) for o in offsets]
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))
    up = torch.nn.functional.pad(u.T, (lo, hi))              # (3, lo+N+hi)
    acc = [None, None, None]
    for d, off in enumerate(offsets):
        ush = up[:, lo + off:lo + off + N]
        for c in range(3):
            for c2 in range(3):
                term = vals[9 * d + 3 * c + c2] * ush[c2]
                acc[c] = term if acc[c] is None else acc[c] + term
    return torch.stack(acc, dim=-1)


# offsets the CUDA kernel takes in its parameter block (csrc/dia_matvec.cu)
MAX_OFFSETS = 96


class _DiaParams(ctypes.Structure):
    """Mirror of ``struct DiaParams`` in csrc/dia_matvec.cu, field by
    field."""
    _fields_ = [("n", ctypes.c_int), ("ld", ctypes.c_int),
                ("dn", ctypes.c_int), ("off", ctypes.c_int * MAX_OFFSETS)]


def padded_stride(n_nodes: int) -> int:
    """Node stride of the planes: N rounded up to a multiple of 4."""
    return -(-n_nodes // 4) * 4


class BlockDIA:
    """Assembled offset operator for one mesh, on the kernel's device.

    ``launches`` counts CUDA kernel launches (one per application of an
    :meth:`operator` on CUDA tensors; each launch is an enqueue that ends a
    gap of :mod:`~safeincave_torch.tracing`)."""

    def __init__(self, kern, max_offsets: int = MAX_OFFSETS,
                 min_fill: float = 0.4):
        self.plan = DIAPlan(kern.conn_np, kern.n_nodes,
                            max_offsets=max_offsets, min_fill=min_fill)
        if self.plan.Dn > MAX_OFFSETS:
            raise ValueError(f"{self.plan.Dn} offsets: the DIA kernel takes "
                             f"at most {MAX_OFFSETS}")
        self.n_nodes = kern.n_nodes
        self.ld = padded_stride(kern.n_nodes)
        self.device = kern.conn.device     # carries the CUDA index
        self._geom = kern.geom
        try:
            self._sp = StructuredPlan(kern.conn_np, kern.n_nodes,
                                      self.plan.offsets)
        except ValueError:
            self._sp = None
        self.offsets = self.plan.offsets.tolist()
        self._params = _DiaParams(self.n_nodes, self.ld, self.plan.Dn,
                                  (ctypes.c_int * MAX_OFFSETS)(*self.offsets))
        self._slot_plan = None             # general assembly, built on use
        self.launches = 0

    @property
    def structured(self):
        """True when the scatter-free strided assembly is active."""
        return self._sp is not None

    def assemble(self, CT_soa):
        """CT (6, 6, E) -> offset planes (Dn*9, ld) in CT's dtype, zero in
        the padding columns."""
        p = self.plan
        gn, vol = self._geom(CT_soa.dtype)
        if self._sp is not None:
            return self._assemble_structured(
                element_block_comp_rows(CT_soa, gn, vol))
        v = element_block_rows(CT_soa, gn, vol)               # (16E, 9)
        if self._slot_plan is None:
            self._slot_plan = ScatterPlan.from_keys(
                p.row_slot, p.Dn * p.n_nodes, self.device)
        flat = segment_sum(v.T, self._slot_plan)              # (9, Dn*N)
        planes = (flat.reshape(9, p.Dn, p.n_nodes).transpose(0, 1)
                  .reshape(p.Dn * 9, p.n_nodes))
        return torch.nn.functional.pad(planes, (0, self.ld - p.n_nodes))

    def _assemble_structured(self, v):
        """Scatter-free assembly from comp rows (144, E).

        1. restack t-major -> (864, H), cells last;
        2. insert zero cell planes at i = nx, j = ny, k = nz (three
           pad + reshape steps), after which padded cell m and its base
           node share one flat index;
        3. each (t, a, b) combo adds its 9 rows into offset plane
           d(t, a, b) at the constant flat shift of corner a.
        """
        sp, p = self._sp, self.plan
        nx, ny, nz = sp.nx, sp.ny, sp.nz
        N = p.n_nodes
        sy, sx = nz + 1, (ny + 1) * (nz + 1)
        pad = torch.nn.functional.pad
        V = torch.cat([v[:, t::6] for t in range(6)], dim=0)  # (864, H)
        V = pad(V.reshape(864 * nx * ny, nz), (0, 1))
        V = pad(V.reshape(864 * nx, ny * (nz + 1)), (0, nz + 1))
        V = pad(V.reshape(864, nx * (ny + 1) * (nz + 1)), (0, sx))  # (864, N)
        dmax = sx + sy + 1
        Vp = pad(V, (dmax, 0))
        planes = torch.zeros((p.Dn, 9, self.ld), dtype=v.dtype,
                             device=v.device)
        for (t, a, b, d_idx, (di, dj, dk)) in sp.table:
            delta = di * sx + dj * sy + dk
            r0 = t * 144 + (4 * a + b) * 9
            planes[d_idx, :, :N] += Vp[r0:r0 + 9,
                                       dmax - delta:dmax - delta + N]
        return planes.reshape(p.Dn * 9, self.ld)

    # ------------------------------------------------------------------ #
    def matvec(self, vals, u):
        """Stiffness action (N, 3) -> (N, 3) in the dtype of ``vals`` (f32
        or f64); ``u`` must have the same dtype.  A solver applies the same
        planes many times through :meth:`operator`."""
        return self.operator(vals)(u)

    def operator(self, vals):
        """The action ``u -> A u`` of the planes ``vals`` (from
        :meth:`assemble`, or its cast).  CPU planes give the plain twin.
        CUDA planes are checked here, once (device, dtype, shape,
        contiguity); each application checks ``u`` alone and launches the
        kernel."""
        N, dtype = self.n_nodes, vals.dtype
        if vals.device.type == "cpu":
            def plain(u):
                if u.device.type != "cpu" or u.dtype != dtype:
                    raise ValueError(f"dia_matvec: u is {u.dtype} on "
                                     f"{u.device}, planes {dtype} on cpu")
                return dia_matvec_plain(vals, u, self.offsets, N)
            return plain
        from .. import _build
        if dtype not in (F32, F64):
            raise ValueError(f"dia_matvec: no kernel for {dtype}")
        shape = (self.plan.Dn * 9, self.ld)
        if vals.device != self.device or tuple(vals.shape) != shape or \
                not vals.is_contiguous() or vals.data_ptr() % 16:
            raise ValueError(
                f"dia_matvec: planes must be a contiguous, 16-byte aligned "
                f"{shape} tensor on {self.device}, got {tuple(vals.shape)} "
                f"on {vals.device}")
        name = "dia_matvec_f32" if dtype == F32 else "dia_matvec_f64"
        fn, check = _build.kernel("dia_matvec", name)
        stream = _build.stream_query(self.device)
        dev, params = self.device, ctypes.addressof(self._params)

        def launch(u):
            if u.device != dev or u.dtype != dtype or u.shape != (N, 3) or \
                    not u.is_contiguous():
                raise ValueError(
                    f"dia_matvec: u must be a contiguous ({N}, 3) {dtype} "
                    f"tensor on {dev}, got {tuple(u.shape)} {u.dtype} on "
                    f"{u.device}")
            y = torch.empty((N, 3), dtype=dtype, device=dev)
            check(fn(params, vals.data_ptr(), u.data_ptr(), y.data_ptr(),
                     stream()))
            tracing.enqueue()
            self.launches += 1
            return y

        return launch
