"""f32 band stiffness action: the hand-written CUDA kernel and its plain twin.

Port of ``safeincave_tpu/fem/bandkernel.py`` (``_band_kernel``, the Pallas
TPU kernel).  The CUDA source, ``csrc/band_matvec.cu``, says what it replaces,
what bounds it and how it is laid out.  The wrapper launches it for CUDA
tensors and uses :func:`band_matvec_plain` only for CPU tensors; a CUDA
tensor that the kernel cannot take raises.

The tangent is packed once per linear solve with the element volume folded
in (``ctv = CT * vol``, (36, E) f32), as the TPU kernel does.
"""
from __future__ import annotations

import torch

from .kernels import (F32, ScatterPlan, forces_stacked, gather_u, scatter,
                      strain_stacked)


def band_matvec_plain(ctv, gN, conn, plan: ScatterPlan, u):
    """Plain PyTorch f32 element matvec: ctv (36, E), gN (12, E) with row
    ``a * 3 + i``, conn (E, 4), u (N, 3) -> (N, 3), assembled by the cumsum
    plan."""
    E = ctv.shape[1]
    gN3 = gN.reshape(4, 3, E)
    ev = strain_stacked(gather_u(u, conn), gN3)                   # (6, E)
    sv = (ctv.reshape(6, 6, E) * ev[None]).sum(1)                 # (6, E)
    return scatter(forces_stacked(sv, gN3), plan)


class BandMatvec:
    """f32 stiffness action for one mesh, on the kernel's device.

    ``launches`` counts kernel launches (one per :meth:`matvec` on CUDA)."""

    def __init__(self, kern):
        self.n_nodes = kern.n_nodes
        self.n_elems = kern.n_elems
        self.device = kern.conn.device     # carries the CUDA index
        gN, vol = kern.geom(F32)
        self.gN = gN.reshape(12, self.n_elems).contiguous()
        self.vol = vol
        self.conn = kern.conn
        self.plan = kern.plan
        # int32 copies for the CUDA kernel
        i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
        self._conn32 = i32(kern.conn)
        self._perm32 = i32(kern.plan.perm)
        self._starts32 = i32(kern.plan.starts)
        self._ends32 = i32(kern.plan.ends)
        self.launches = 0

    def pack_ct(self, CT_soa32):
        """(6, 6, E) f32 tangent -> vol-folded (36, E) f32, once per solve."""
        return (CT_soa32 * self.vol).reshape(36, self.n_elems).contiguous()

    def matvec(self, ctv, u):
        """(N, 3) f32 -> (N, 3) f32."""
        if u.device.type == "cpu":
            return band_matvec_plain(ctv, self.gN, self.conn, self.plan, u)
        return self._launch(ctv, u)

    def _launch(self, ctv, u):
        from .._build import load
        E, N = self.n_elems, self.n_nodes
        for name, t, shape in (("ctv", ctv, (36, E)), ("u", u, (N, 3))):
            if t.device != self.device or t.dtype != F32 or \
                    tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(
                    f"band_matvec: {name} must be a contiguous {shape} "
                    f"float32 tensor on {self.device}, got "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if self.device.type != "cuda":
            raise ValueError(f"band_matvec: no kernel for {self.device}")
        lib = load("band_matvec")
        fe = torch.empty((12, E), dtype=F32, device=self.device)
        f = torch.empty((N, 3), dtype=F32, device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = lib.band_matvec_f32(
            ctv.data_ptr(), self.gN.data_ptr(), self._conn32.data_ptr(),
            self._perm32.data_ptr(), self._starts32.data_ptr(),
            self._ends32.data_ptr(), u.data_ptr(), fe.data_ptr(),
            f.data_ptr(), E, N, stream)
        if err != 0:
            msg = lib.band_matvec_error_string(err).decode()
            raise RuntimeError(f"band_matvec_f32 launch failed: {msg}")
        self.launches += 1
        return f
