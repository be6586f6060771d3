"""Rank bodies of tests/test_torch_dist.py, run by
``safeincave_torch.parallel.dist.launch`` in spawned processes (gloo on the
CPU, one thread each).  This module imports no JAX, so the children stay
light; the JAX references come from the parent.

Each function takes the rank's communicator first and returns numpy arrays.
The exchanges of :func:`halo_layer` go through :class:`CheckedComm`, which
sends each message's shape and dtype ahead of it and asserts them on the
receiving end: gloo's point-to-point ops check neither, and a float32 send
received into a float64 buffer would read as garbage without an error.
"""
import os

import numpy as np
import torch

import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_torch.parallel import dist, halo as thalo
from safeincave_torch.parallel import make_device_mesh, shard_equation, shard_tm

_DTYPES = (torch.float32, torch.float64, torch.int64)


class CheckedComm(dist.Comm):
    """A :class:`Comm` whose ``exchange`` first swaps a header (rows, row
    width, dtype code) with every peer and asserts it against what the
    receiver expects."""

    def __init__(self, comm):
        super().__init__(comm.rank, comm.world, comm.device, comm.group)
        self.checked = 0

    def exchange(self, sends, recvs):
        def head(shape, dtype):
            width = int(np.prod(shape[1:], dtype=np.int64))
            return torch.tensor([shape[0], width, _DTYPES.index(dtype)],
                                dtype=torch.int64)

        got = super().exchange(
            [(p, head(tuple(t.shape), t.dtype)) for p, t in sends],
            [(p, (3,), torch.int64) for p, _, _ in recvs])
        for (p, shape, dtype), h in zip(recvs, got):
            assert torch.equal(h, head(shape, dtype)), \
                f"rank {self.rank}: from {p} {h.tolist()}, expected " \
                f"{head(shape, dtype).tolist()}"
            self.checked += 1
        return super().exchange(sends, recvs)


def halo_inputs(grid, seed=0):
    """tests/test_halo.py's random SPD tangents, vector and mask."""
    rng = np.random.default_rng(seed)
    E, N = grid.n_elems, grid.n_nodes
    A = rng.normal(size=(E, 6, 6))
    CT = A @ np.transpose(A, (0, 2, 1)) + 6 * np.eye(6)
    u = rng.normal(size=(N, 3))
    mask = (rng.random((N, 3)) > 0.1).astype(float)
    return CT, u, mask


def exchange_inputs(plan, seed=1):
    """Random owned rows (D, S, 3) and halo partials (D, H+1, 3), the dump
    slot zero, for the exchange rounds."""
    rng = np.random.default_rng(seed)
    u_own = rng.normal(size=(plan.D, plan.S, 3))
    f_halo = rng.normal(size=(plan.D, plan.H + 1, 3))
    f_halo[:, plan.H] = 0.0
    return u_own, f_halo


def halo_layer(comm, nx, D):
    """The halo solver of GridBox(nx) in D parts over the ranks: the
    forward and reverse rounds of :func:`exchange_inputs` (this rank's
    parts), the f64 and f32 matvec (whole vectors) and the block diagonal
    (this rank's rows) of :func:`halo_inputs`, with the rank's element
    block of the tangents."""
    ccomm = CheckedComm(comm)
    grid = st.GridBox(nx=nx, ny=nx, nz=nx)
    solver = thalo.HaloMomentumSolver(grid, make_device_mesh(D, comm=ccomm))
    plan, parts = solver.plan, slice(solver.first_part,
                                     solver.first_part + solver.D_loc)
    u_own, f_halo = exchange_inputs(plan)
    T = torch.as_tensor
    out = {"fwd": solver._fwd_exchange(T(u_own[parts])).numpy(),
           "rev": solver._rev_exchange(T(f_halo[parts]), (3,)).numpy(),
           "fwd32": solver._fwd_exchange(T(u_own[parts]).float()).numpy()}
    CT, u, mask = halo_inputs(grid)
    n_blk = grid.n_elems // comm.world
    CT_blk = T(CT[comm.rank * n_blk:(comm.rank + 1) * n_blk])
    CT_l = solver.ct_to_local(CT_blk)
    mp = solver.to_padded(T(mask))
    out["matvec"] = solver.from_padded(
        solver.matvec_padded(CT_l, solver.to_padded(T(u)), mp)).numpy()
    out["matvec32"] = solver.from_padded(solver.matvec_pad(
        CT_l.float(), solver.to_padded(T(u).float()), mp.float())).numpy()
    out["blockdiag"] = solver.block_diagonal_padded(CT_l).numpy()
    out["checked"] = ccomm.checked
    out["rows_sent"] = solver.rows_sent_per_matvec()
    return out


def sharded_steps(comm, mode, nx, D, fp32_phase, ckpt_dir=None):
    """``shard_equation`` of the sharding cube on GridBox(nx) in D parts
    over the ranks: the elastic response and 2 steps (u, sig_v at the true
    element count, the rows, the steps whose f32 sweep was accepted).  With ``ckpt_dir``: a checkpoint of the
    final state (rank 0 writes ck.npz), loaded into a fresh sharded
    equation and saved again (ck2.npz)."""
    eq = cfg.sharding_box(st, nx=nx, device="cpu", fp32_phase=fp32_phase)
    shard_equation(eq, make_device_mesh(D, comm=comm), mode=mode)
    u, _, rows = cfg.run_sharding_steps(eq)
    out = {"u": u, "sig": st.utils.unpad_elems(eq, eq.sig_v), "rows": rows,
           "n_local": eq.n_elems, "fp32_accepted": eq.fp32_accepted}
    if ckpt_dir is not None:
        st.save_checkpoint(os.path.join(ckpt_dir, "ck.npz"), eq)
        comm.barrier()
        eq2 = cfg.sharding_box(st, nx=nx, device="cpu")
        shard_equation(eq2, make_device_mesh(D, comm=comm), mode=mode)
        st.load_checkpoint(os.path.join(ckpt_dir, "ck.npz"), eq2)
        out["loaded_equal"] = all(
            torch.equal(getattr(eq2, k), getattr(eq, k))
            for k in ("sig_v", "eps_tot_v", "Temp", "T0", "u"))
        st.save_checkpoint(os.path.join(ckpt_dir, "ck2.npz"), eq2)
    return out


def tm_steps(comm, D, n_steps=2):
    """``shard_tm`` of ``torch_port_configs.tm_cube`` in D parts over the
    ranks, ``n_steps`` fused coupled steps: u, sig_v, T and the rows."""
    eq, heat = cfg.tm_cube(st, "cpu")
    shard_tm(eq, heat, make_device_mesh(D, comm=comm))
    cfg.tm_init(eq, heat)
    rows = eq.solve_tm_time_steps(heat, [(k + 1) * cfg.HOUR
                                         for k in range(n_steps)],
                                  [cfg.HOUR] * n_steps, tol=1e-6, maxiter=20)
    return {"u": cfg.as_np(eq.u), "sig": st.utils.unpad_elems(eq, eq.sig_v),
            "T": cfg.as_np(heat.T), "rows": rows}


def skip_collective(comm):
    """Rank 0 all-reduces; the other ranks never do."""
    if comm.rank == 0:
        comm.allreduce_sum(torch.ones(1))
    else:
        import time
        time.sleep(60)


def sleep(comm, seconds):
    import time
    time.sleep(seconds)
