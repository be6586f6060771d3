"""Captured CUDA graphs of a time step's pieces: the port's counterpart of
``jax.jit``.

The JAX package runs a linear solve, a fixed-point iteration and a chunk of
time steps each as one XLA program.  Here a function of tensors becomes a
``torch.cuda.CUDAGraph``, captured on its first call and replayed after:
one launch on the host for the hundreds of small kernels of a tangent
build, a right-hand side, an update or a block of Krylov iterations.

:class:`Graphs` holds the graphs of one equation, in one memory pool:

* ``graphs(key, fn, *args)`` is ``fn(*args)``.  ``args`` and the result are
  nests of tuples, lists and dicts whose leaves are tensors or hashable
  constants.  The graph is keyed by ``key``, the nest's structure, every
  tensor's shape and dtype and every constant: a Python float (``dt``,
  ``theta``, a tolerance) is baked into the capture, so a new value captures
  a new graph.  Before a replay each tensor is copied into the graph's
  static input, unless it is the one copied last time and unchanged since.
  Tensors of the result are cloned after the replay, so nothing that
  outlives it aliases a buffer the next replay overwrites; a result that is
  an input passed through comes back as the caller's own tensor.  ``fn``
  must not write into its inputs.
* ``graphs.step(key, fn, state)`` runs ``fn(state) -> (state', out)`` for a
  loop carried in place: ``state'`` is written into the graph's static
  state, which is returned, so the next call with the returned tuple copies
  nothing (a slot the graph writes is always copied into from any other
  tensor).  The state holds until the next call with this key; ``out`` is
  cloned.
* ``graphs.bind(name, tensor)`` copies ``tensor`` into a buffer that lives
  as long as the graphs: an operator that a graph closes over reads its
  data from bound buffers, refreshed before the replay.

A capture runs ``fn`` once on a side stream first (the first use of every
operation, a kernel's shared-memory attribute, lazily built tables), then
captures it and replays.  A failed capture or replay raises; nothing falls
back to running uncaptured.  ``counters`` gives the objects whose
``launches`` count a hand kernel's launches in its Python wrapper: what a
capture adds is taken off again and added on every replay, so the counts
stay those of kernels that ran.

On a CPU device, inside :func:`eager`, and for a :class:`Graphs` made with
``enabled=False`` (the parallel layer's equations) the function is called
directly.  :func:`eager` is the counterpart of ``jax.disable_jit``: the same
functions, uncaptured, on the card, for tests and chip_smoke.py.

A replay is a ``replay`` span of :mod:`~safeincave_torch.tracing` (its
launch is an enqueue, which ends a gap), a capture a ``capture`` span;
``replays`` and ``captures`` count them, and each run record lists the
keys captured in it.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict

import torch

from .. import tracing

_eager_depth = [0]
_MAX_GRAPHS = 32        # least recently used graphs beyond this are dropped


@contextlib.contextmanager
def eager():
    """Run every :class:`Graphs` call uncaptured, as ``jax.disable_jit``
    runs jitted functions op by op."""
    _eager_depth[0] += 1
    try:
        yield
    finally:
        _eager_depth[0] -= 1


def _flatten(x, leaves):
    """The hashable structure of nest ``x``; its tensors go to ``leaves``."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("T", tuple(x.shape), x.dtype)
    if isinstance(x, dict):
        return ("D", tuple((k, _flatten(v, leaves)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return ("L" if isinstance(x, list) else "U",
                tuple(_flatten(v, leaves) for v in x))
    return ("C", x)


def _unflatten(sig, it):
    tag = sig[0]
    if tag == "T":
        return next(it)
    if tag == "D":
        return {k: _unflatten(s, it) for k, s in sig[1]}
    if tag == "L":
        return [_unflatten(s, it) for s in sig[1]]
    if tag == "U":
        return tuple(_unflatten(s, it) for s in sig[1])
    return sig[1]


class _Graph:
    """One captured graph: its static inputs, the source each was last
    copied from (and that source's version), its outputs and what each
    output is (an input passed through, or a tensor of the graph)."""

    def __init__(self, graph, static, out, out_sig, through, deltas):
        self.graph, self.static = graph, static
        self.out, self.out_sig, self.through = out, out_sig, through
        self.deltas = deltas                 # [(counter owner, launches)]
        self.last = [None] * len(static)
        self.version = [0] * len(static)
        self.written = None     # the slots a step graph writes back


class Graphs:
    """The captured graphs of one equation on ``device``, sharing one
    memory pool.  ``replays`` counts graph launches, ``captures`` graphs
    captured."""

    def __init__(self, device, counters=lambda: (), enabled=True):
        self.device = torch.device(device)
        self.counters = counters
        self.enabled = enabled
        self.replays = self.captures = 0
        self._graphs: OrderedDict = OrderedDict()
        self._bound: dict = {}
        self._pool = self._stream = None

    @property
    def live(self) -> bool:
        """Whether calls capture and replay (CUDA, enabled, not eager)."""
        return (self.enabled and self.device.type == "cuda"
                and not _eager_depth[0])

    def clear(self):
        """Drop every graph and bound buffer (the operator, preconditioner
        or backend they referenced changed)."""
        self._graphs.clear()
        self._bound.clear()
        self._pool = None

    def bind(self, name, t):
        """``t`` in the buffer bound to ``name`` (one per shape and dtype),
        copied only when it is not the tensor copied last, unchanged."""
        if not self.live:
            return t
        key = (name, tuple(t.shape), t.dtype)
        slot = self._bound.get(key)
        if slot is None:
            slot = self._bound[key] = [torch.empty_like(
                t, memory_format=torch.contiguous_format), None, 0]
        buf, src, ver = slot
        if not (src is t and ver == t._version):
            buf.copy_(t)
            slot[1], slot[2] = t, t._version
        return buf

    def runner(self, prefix):
        """``run(tag, fn, state)`` for the Krylov loops of
        :mod:`~safeincave_torch.fem.solvers`: :meth:`step` under the key
        ``(prefix, tag)``."""
        return lambda tag, fn, state: self.step((prefix, tag), fn, state)

    # ------------------------------------------------------------------ #
    def __call__(self, key, fn, *args):
        if not self.live:
            return fn(*args)
        leaves = []
        sig = _flatten(args, leaves)
        g = self._get(("call", key, sig), leaves,
                      lambda *st: fn(*_unflatten(sig, iter(st))))
        self._replay(g, leaves)
        made = {}
        out = []
        for t, j in zip(g.out, g.through):
            if j is not None:
                out.append(leaves[j])
                continue
            c = made.get(id(t))
            if c is None:
                c = made[id(t)] = t.clone()
            out.append(c)
        return _unflatten(g.out_sig, iter(out))

    def step(self, key, fn, state):
        if not self.live:
            return fn(state)

        written = []

        def in_place(*st):
            new, out = fn(st)
            # a new value that is another slot's buffer is read before the
            # write-back overwrites that slot
            ids = {id(s) for s in st}
            new = [v.clone() if v is not s and id(v) in ids else v
                   for s, v in zip(st, new)]
            written[:] = [i for i, (s, v) in enumerate(zip(st, new))
                          if v is not s]
            for i in written:
                st[i].copy_(new[i])
            return out

        state = tuple(state)
        sig = _flatten(state, [])
        key = ("step", key, sig)
        g = self._get(key, list(state), in_place)
        if g.written is None:
            g.written = tuple(written)
        self._replay(g, state)
        for i in g.written:      # the slot no longer holds what was copied
            g.last[i] = None
        (out,) = g.out
        return tuple(g.static), out.clone()

    # ------------------------------------------------------------------ #
    def _get(self, full_key, leaves, fn):
        g = self._graphs.get(full_key)
        if g is None:
            tracing.begin(tracing.CAPTURE)
            g = self._capture(fn, leaves)
            tracing.end(tracing.CAPTURE)
            self.captures += 1
            tracing.captured(full_key[:2])
            self._graphs[full_key] = g
            while len(self._graphs) > _MAX_GRAPHS:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(full_key)
        return g

    def _capture(self, fn, leaves):
        static = [t.detach().clone() for t in leaves]
        cur = torch.cuda.current_stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        side = self._stream
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph() would also collect garbage and empty the
        # allocator's cache on every capture; a new dt captures anew
        with torch.cuda.stream(side):
            fn(*static)                      # warm-up, outside the capture
            owners = [o for o in self.counters() if o is not None]
            before = [o.launches for o in owners]
            graph.capture_begin(pool=self._pool)
            try:
                out = fn(*static)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        cur.wait_stream(side)
        deltas = []
        for o, b in zip(owners, before):
            deltas.append((o, o.launches - b))
            o.launches = b                   # a capture launches nothing
        out_leaves = []
        out_sig = _flatten(out, out_leaves)
        index = {id(t): i for i, t in enumerate(static)}
        through = [index.get(id(t)) for t in out_leaves]
        return _Graph(graph, static, out_leaves, out_sig, through, deltas)

    def _replay(self, g, leaves):
        tracing.begin(tracing.REPLAY)
        for i, (s, t) in enumerate(zip(g.static, leaves)):
            if t is s or (g.last[i] is t and g.version[i] == t._version):
                continue
            s.copy_(t)
            g.last[i], g.version[i] = t, t._version
        g.graph.replay()
        tracing.replay_end()
        self.replays += 1
        for o, n in g.deltas:
            o.launches += n
