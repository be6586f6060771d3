"""Process group of a multi-card run: one rank per device.

A run on W cards starts W processes, one per card, each holding D/W of the
D parts of a :class:`~safeincave_torch.parallel.PartMesh` (stacked on a
leading axis, as a single-process run stacks all D).  Between ranks the
parallel layer needs these collectives, which :class:`Comm` wraps:

* ``allreduce_sum`` / ``allreduce_max``: the JAX package's ``psum`` and the
  global reductions that steer the fixed-point and Krylov loops (every rank
  must take the same branch, so each such number is all-reduced);
* ``all_gather``: element tangents into the halo parts' order, owned rows
  into the global nodal layout;
* ``exchange``: one halo round, a ``batch_isend_irecv`` of packed rows with
  every peer the round pairs this rank with (the ``ppermute``);
* ``from_rank0``: what is built once from the whole mesh (the dense and
  coarse preconditioner inverses), made on rank 0 and broadcast, so that
  replicated state holds the same bits on every rank.

On CUDA devices the group is NCCL, on the CPU gloo.  Users start the ranks
with ``torchrun --standalone --nproc_per_node W script.py`` and call
:func:`init_parts` in each; tests and smoke runs use :func:`launch`.  Every
group has a finite timeout, so a collective that one rank never reaches
raises instead of hanging.  Nothing falls back: without a card (and without
``device="cpu"``) :func:`init_parts` raises, and a group that does not form
raises.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = timedelta(seconds=300)

_current = None


class Comm:
    """One rank's handle on the process group: ``rank``, ``world``, its
    ``device`` and the collectives of the parallel layer.  ``counts``
    tallies the collectives issued (all-reduces, gathers, broadcasts,
    exchange rounds and the bytes they sent), for measurements."""

    def __init__(self, rank: int, world: int, device, group=None):
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device(device)
        self.group = group
        self.counts = {"allreduce": 0, "all_gather": 0, "broadcast": 0,
                       "rounds": 0, "bytes_sent": 0}

    def reset_counts(self):
        for k in self.counts:
            self.counts[k] = 0

    def allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, the same bits on every rank,
        in place."""
        return self._allreduce(t, dist.ReduceOp.SUM)

    def allreduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the ranks, in place."""
        return self._allreduce(t, dist.ReduceOp.MAX)

    def _allreduce(self, t, op):
        self.counts["allreduce"] += 1
        return _in_place(t, lambda buf: dist.all_reduce(buf, op=op,
                                                         group=self.group))

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of rank ``src`` on every rank, in place."""
        self.counts["broadcast"] += 1
        return _in_place(t, lambda buf: dist.broadcast(buf, src,
                                                       group=self.group))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated along the leading axis, in rank
        order.  Boolean tensors travel as bytes."""
        is_bool = t.dtype == torch.bool
        src = (t.to(torch.uint8) if is_bool else t).contiguous()
        out = src.new_empty((self.world * src.shape[0], *src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=self.group)
        self.counts["all_gather"] += 1
        return out.bool() if is_bool else out

    def from_rank0(self, build):
        """``build()``, a tuple of tensors and picklable values, made on
        rank 0 alone: the other ranks receive each tensor into a buffer of
        rank 0's shape, strides and dtype, and the values pickled."""
        out = build() if self.rank == 0 else None
        meta = [None if out is None else [
            ("tensor", tuple(v.shape), v.stride(), v.dtype)
            if isinstance(v, torch.Tensor) else ("value", v) for v in out]]
        dist.broadcast_object_list(meta, 0, group=self.group,
                                   device=self.device)
        got = []
        for i, (kind, *m) in enumerate(meta[0]):
            if kind == "value":
                got.append(m[0])
                continue
            t = out[i] if out is not None else torch.empty_strided(
                m[0], m[1], dtype=m[2], device=self.device)
            got.append(self.broadcast(t))
        return tuple(got)

    def exchange(self, sends, recvs):
        """One round of point-to-point messages: ``sends`` is a list of
        (peer, tensor), ``recvs`` a list of (peer, shape, dtype), at most
        one of each per peer.  Every op goes into one ``batch_isend_irecv``,
        sorted by peer, as the matching ends post theirs.  Returns the
        received tensors in the order of ``recvs``."""
        bufs = [torch.empty(shape, dtype=dtype, device=self.device)
                for _, shape, dtype in recvs]
        ops = []
        for peer, t in sorted(sends, key=lambda s: s[0]):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), peer,
                                  group=self.group))
            self.counts["bytes_sent"] += t.numel() * t.element_size()
        for i in sorted(range(len(recvs)), key=lambda i: recvs[i][0]):
            ops.append(dist.P2POp(dist.irecv, bufs[i], recvs[i][0],
                                  group=self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self.counts["rounds"] += 1
        return bufs

    def barrier(self):
        """Wait for every rank (an all-reduce of one element, which NCCL
        and gloo order with the other collectives alike)."""
        self.allreduce_sum(torch.zeros(1, device=self.device))


def _in_place(t, collective):
    """Run an in-place ``collective`` on ``t`` and return ``t``.  A
    non-contiguous ``t`` goes through a contiguous copy and keeps its
    layout: a transposed operand (``torch.linalg.inv`` returns one) takes
    other kernels, with other roundings, than its contiguous copy."""
    buf = t.contiguous()
    collective(buf)
    if buf is not t:
        t.copy_(buf)
    return t


def current() -> Comm | None:
    """The communicator :func:`init_parts` made in this process, or None."""
    return _current


def init_parts(device=None, timeout: timedelta | float = DEFAULT_TIMEOUT,
               rank: int | None = None, world: int | None = None,
               store=None, local_rank: int | None = None) -> Comm:
    """Join the process group of a multi-card run and return this rank's
    :class:`Comm` (also what :func:`current` returns from then on).

    ``rank`` and ``world`` default to ``torchrun``'s ``RANK`` and
    ``WORLD_SIZE``, the device to ``cuda:{LOCAL_RANK}`` with NCCL;
    ``device="cpu"`` takes gloo.  Without ``store`` the group meets through
    ``MASTER_ADDR`` / ``MASTER_PORT`` (``torchrun`` sets both).  Raises
    without a CUDA device unless ``device="cpu"`` is given.  The group
    opens with an all-reduce, which every rank must reach within
    ``timeout`` (seconds or a ``timedelta``), as must every later
    collective."""
    global _current
    if not isinstance(timeout, timedelta):
        timeout = timedelta(seconds=float(timeout))
    env = os.environ
    if rank is None or world is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            raise ValueError("init_parts: give rank and world, or start the "
                             "ranks with torchrun (RANK, WORLD_SIZE)")
        rank = int(env["RANK"]) if rank is None else rank
        world = int(env["WORLD_SIZE"]) if world is None else world
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_parts: no CUDA device is visible; pass device=\"cpu\" "
                "to run the ranks on the CPU")
        n_cards = torch.cuda.device_count()
        index = local_rank if dev is None or dev.index is None else dev.index
        if index >= n_cards:
            raise RuntimeError(f"init_parts: local rank {local_rank} needs "
                               f"card {index}, {n_cards} visible")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    if dist.is_initialized():
        raise RuntimeError("init_parts: this process already is in a "
                           "process group")
    kw = {"store": store} if store is not None else {}
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=timeout, **kw)
    comm = Comm(rank, world, dev)
    # the first collective of a group must involve every rank before any
    # point-to-point op
    opened = comm.allreduce_sum(torch.ones(1, device=dev))
    if int(opened.item()) != world:
        raise RuntimeError(f"init_parts: {int(opened.item())} of {world} "
                           f"ranks joined")
    comm.reset_counts()
    _current = comm
    return comm


def shutdown():
    """Leave the process group :func:`init_parts` joined."""
    global _current
    if dist.is_initialized():
        dist.destroy_process_group()
    _current = None


def _child(rank, fn, world, device, tmp, args, group_timeout):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    comm = init_parts(device=device, rank=rank, world=world, store=store,
                      timeout=group_timeout, local_rank=rank)
    try:
        out = fn(comm, *args)
    finally:
        shutdown()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".part", path)


def launch(fn, world: int, device="cuda", args=(), timeout: float = 600.0,
           group_timeout: timedelta | float = DEFAULT_TIMEOUT) -> list:
    """Run ``fn(comm, *args)`` on ``world`` spawned ranks, rank r on
    ``cuda:r`` (or all on the CPU with ``device="cpu"``, gloo, one thread
    each), meeting through a ``FileStore`` in a temporary directory.
    ``fn`` must be importable by name (a module-level function) and return
    something picklable.  Returns the ranks' results in rank order.

    A rank that raises fails the launch and the other ranks are stopped; a
    launch that outlives ``timeout`` seconds kills every rank and raises
    ``TimeoutError``: it never hangs."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_child, args=(fn, world, device, tmp, args,
                                     group_timeout),
                       nprocs=world, join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"launch: {world} ranks still running "
                                       f"after {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
