"""f32 symmetric dense matvec from a packed upper triangle: the dense
preconditioner's apply, its hand-written CUDA kernel and its plain twin.

The dense preconditioner (fem/momentum.py, ``build_preconditioner``) is the
inverse of the masked elastic operator, which is symmetric.  It is
symmetrized, ``0.5 (inv + inv^T)`` as the coarse inverse of the two-level
preconditioner is, and only its upper triangle is kept: square tiles of
B x B for tile rows I and tile columns J >= I, zero-padded to ``nb B``, laid
out row by row, with B = 128.  A tile is stored as 4 chunks of 128 rows by
32 columns, which the kernel fetches whole.  The CUDA source,
``csrc/sym_dense_matvec.cu``, says what bounds it and how it sums;
:class:`SymPlan` is the host side of its two-pass sum.  :class:`SymDense` launches it for CUDA tensors and uses
:func:`sym_dense_plain` only for CPU tensors; a CUDA tensor that the kernel
cannot take raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import tracing
from .kernels import F32

B = 128             # tile size, as csrc/sym_dense_matvec.cu has it
NC = B // 32        # chunks per tile


def n_blocks(n: int) -> int:
    return -(-n // B)


def n_chunks(n: int) -> int:
    """Chunks (B x 32) of the packed upper triangle of an n x n matrix."""
    nb = n_blocks(n)
    return NC * nb * (nb + 1) // 2


def chunk_index(n: int):
    """(row block, column chunk) of every packed chunk, in storage order:
    row blocks I in order, then column chunks j = NC I ... NC nb - 1 (the
    first NC are the diagonal tile's)."""
    nb = n_blocks(n)
    rows = np.repeat(np.arange(nb), NC * (nb - np.arange(nb)))
    start = np.concatenate([[0], np.cumsum(NC * (nb - np.arange(nb)))])
    cols = np.arange(len(rows)) - start[rows] + NC * rows
    return rows, cols


def pack_upper(inv):
    """The upper triangle of ``0.5 (inv + inv^T)`` ((n, n) f32) as
    (n_chunks, B, 32) f32 chunks on inv's device.  It is formed one strip
    of B rows at a time, so the pack never holds a second full matrix; its
    entries are those of ``0.5 * (inv + inv.T)`` bit for bit, and entries
    (i, j) and (j, i) are the same float."""
    n = inv.shape[0]
    nb = n_blocks(n)
    out = torch.empty((n_chunks(n), B, 32), dtype=F32, device=inv.device)
    strip = torch.empty((B, nb * B), dtype=F32, device=inv.device)
    k = 0
    for I in range(nb):
        r0, r1 = I * B, min(n, (I + 1) * B)
        m = NC * (nb - I)
        s = strip[:, :m * 32]
        s.zero_()
        blk = s[:r1 - r0, :n - r0]
        blk.copy_(inv[r0:r1, r0:])
        blk.add_(inv[r0:, r0:r1].T)
        blk.mul_(0.5)
        out[k:k + m] = s.view(B, m, 32).permute(1, 0, 2)
        k += m
    return out


def sym_dense_plain(tiles, n: int, x, index=None):
    """Plain PyTorch ``y = S x`` of the symmetric S whose packed chunks are
    ``tiles``, (n,) -> (n,), in the dtype of the inputs: every chunk's row
    partial, and the column partial of every off-diagonal chunk, summed
    into y.  ``index`` is :func:`chunk_index` as tensors on x's device
    (made when not given)."""
    nb = n_blocks(n)
    if index is None:
        index = tuple(torch.as_tensor(a, device=x.device)
                      for a in chunk_index(n))
    rows, cols = index
    xp = torch.zeros(nb * B, dtype=x.dtype, device=x.device)
    xp[:n] = x
    x_col = xp.view(nb * NC, 32)[cols]                              # (K, 32)
    x_row = xp.view(nb, B)[rows]                                   # (K, B)
    y = torch.zeros(nb * B, dtype=x.dtype, device=x.device)
    y.view(nb, B).index_add_(0, rows, torch.bmm(
        tiles, x_col[:, :, None])[:, :, 0])
    off = (cols >= NC * (rows + 1)).to(x.dtype)[:, None]
    y.view(nb * NC, 32).index_add_(0, cols, torch.bmm(
        x_row[:, None, :], tiles)[:, 0] * off)
    return y[:n]


class SymPlan:
    """The kernel's two-pass sum for an n x n triangle over ``grid`` blocks
    (host numpy, built once).

    Block b runs the chunks [K b / grid, K (b + 1) / grid) of the K packed
    chunks.  ``cta_row[b]`` is the row block of its first chunk.  Each
    block writes one row partial (B floats) per row block its run touches,
    into consecutive slots from ``cta_seg[b]``; the slots of row block I
    are ``seg_row[I]`` to ``seg_row[I + 1]``, in block order.  The column
    partial of off-diagonal chunk (I, j) goes to slot
    ``sum_{j' < j} floor(32 j' / B) + I`` (the kernel computes it).
    """

    def __init__(self, n: int, sms: int):
        self.n = n
        self.nb = nb = n_blocks(n)
        K = self.n_chunks = n_chunks(n)
        self.grid = G = min(sms, K)
        b = np.arange(G + 1)
        k0 = K * b // G
        row_start = NC * (np.arange(nb + 1) * nb
                         - np.arange(nb + 1) * (np.arange(nb + 1) - 1) // 2)
        first = np.searchsorted(row_start, k0[:-1], side="right") - 1
        last = np.searchsorted(row_start, k0[1:] - 1, side="right") - 1
        self.cta_row = first
        self.cta_seg = np.concatenate([[0], np.cumsum(last - first + 1)])
        slot_rows = np.concatenate([np.arange(f, l_ + 1)
                                    for f, l_ in zip(first, last)])
        self.seg_row = np.searchsorted(slot_rows, np.arange(nb + 1))
        self.n_seg = len(slot_rows)
        self.n_off = NC * nb * (nb - 1) // 2


class _SymPlanC(ctypes.Structure):
    """Mirror of ``struct SymPlan`` in csrc/sym_dense_matvec.cu, field by
    field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "tiles", "cta_row", "cta_seg", "seg_row", "colpart", "rowpart")] + [
        (name, ctypes.c_int) for name in ("n", "nb", "n_chunks", "grid")]


class SymDense:
    """The dense preconditioner ``P = 0.5 (inv + inv^T)`` of an (n, n) f32
    inverse, kept as its packed upper triangle on inv's device (about half
    of inv's memory); ``self(x)`` is ``P x`` for an (n,) f32 vector.

    On CUDA the kernel's grid comes from n and the device's SM count (one
    block per SM, fewer for a small n).  The kernel's scratch is allocated
    here, once, so
    that a captured graph's launches read buffers as old as this object.
    ``launches`` counts kernel launches (each an enqueue that ends a gap of
    :mod:`~safeincave_torch.tracing`).  Applications share the scratch, so
    they run in the order of one stream."""

    def __init__(self, inv):
        n = inv.shape[0]
        self.n, self.device = n, inv.device
        self.tiles = pack_upper(inv)
        self.launches = 0
        self._index = self._plan_c = None
        if self.device.type == "cuda":
            plan = SymPlan(n, torch.cuda.get_device_properties(
                self.device).multi_processor_count)
            as_dev = lambda a: torch.as_tensor(  # noqa: E731
                np.ascontiguousarray(a).astype(np.int32), device=self.device)
            self._tables = dict(
                cta_row=as_dev(plan.cta_row), cta_seg=as_dev(plan.cta_seg),
                seg_row=as_dev(plan.seg_row),
                colpart=torch.empty((max(plan.n_off, 1), 32), dtype=F32,
                                    device=self.device),
                rowpart=torch.empty((plan.n_seg, B), dtype=F32,
                                    device=self.device))
            self._plan_c = _SymPlanC(
                tiles=self.tiles.data_ptr(),
                **{k: v.data_ptr() for k, v in self._tables.items()},
                n=n, nb=plan.nb, n_chunks=plan.n_chunks, grid=plan.grid)
            from .. import _build
            self._fn, self._check = _build.kernel("sym_dense_matvec",
                                                  "sym_dense_matvec_f32")
            self._stream = _build.stream_query(self.device)

    @property
    def shape(self):
        return (self.n, self.n)

    def __call__(self, x):
        """(n,) f32 -> (n,) f32 ``P x``: the kernel for a CUDA ``x`` on this
        device, the plain twin for a CPU ``x`` when P lives on the CPU."""
        n = self.n
        if x.device.type == "cpu" and self._plan_c is None:
            if self._index is None:
                self._index = tuple(torch.as_tensor(a)
                                    for a in chunk_index(n))
            return sym_dense_plain(self.tiles, n, x, self._index)
        if self._plan_c is None or x.device != self.device or \
                x.dtype != F32 or x.shape != (n,) or not x.is_contiguous():
            raise ValueError(
                f"sym_dense_matvec: x must be a contiguous ({n},) float32 "
                f"tensor on {self.device}, got {tuple(x.shape)} {x.dtype} "
                f"on {x.device}")
        y = torch.empty(n, dtype=F32, device=self.device)
        self._check(self._fn(ctypes.addressof(self._plan_c), x.data_ptr(),
                             y.data_ptr(), self._stream()))
        tracing.enqueue()
        self.launches += 1
        return y
