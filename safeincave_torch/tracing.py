"""Spans and counters of the port's own work, on by default.

A **span** is a named stretch of host time: its name (one of
:data:`NAMES`), its start and end on :func:`time.perf_counter_ns`, the span
it opened inside, and the time step it belongs to (:func:`at_step`).  The
simulators, the fixed point, the Krylov loops, the graphs and the writers
open and close them where their work happens:

========== ===============================================================
``run``    ``Simulator_M.run()`` or ``Simulator_TM.run()``; opening and
           closing it makes a run record
``chunk``  ``LinearMomentum.solve_time_steps`` or ``solve_tm_time_steps``
``step``   one time step (inside a fused chunk too), to the return of its
           last read
``commit`` a step's commit
``fixed_point``, ``sweep``, ``krylov``
           the fixed point, its float32 sweep, one Krylov loop
``save``   a kept save of the outputs (derived fields included)
``checkpoint``  ``save_checkpoint``
``read``   a host read of a tensor (:func:`read`)
``replay`` a graph replay, from its first input copy to ``replay()``'s
           return
``capture`` a graph's warm-up call and capture
``precond`` a preconditioner build, ended by a synchronize
``gap``    a stretch in which the device had nothing queued (below)
``heat``   one step of the heat equation (``HeatDiffusion.step``)
========== ===============================================================

Each span goes into a bounded ring (:data:`RING`) and into aggregates per
name: count, total and self nanoseconds (self: the span less the spans
opened inside it).

**Gaps.**  When a read of a CUDA tensor returns, the device has finished
what was queued; until the next enqueue (a graph replay's launch, a
hand-kernel launch, or another read) it idles while the host runs the code
of the innermost open span.  That stretch is added to a gap total keyed by
that span's name (cut where spans open and close, so each piece goes to
the span that held the host; a replay's launch is the ``replay``'s) and put
in the ring as one ``gap`` span.  A run on CUDA also opens a gap at its
start.  Eager PyTorch operations in between are not enqueues here: their
device time counts as gap.  A ``heat`` span keeps the gaps of the spans
opened inside it (the heat step's eager CG loops and their reads) as its
own, so the heat step's idle is named as one cause.

**Device spans** ``tangent`` and ``solve``: CUDA event pairs, from a pool,
around the tangent suite's replay and around each linear solve (the f64
solve and the float32 sweep's).  They resolve (``elapsed_time``) when
complete, at the latest when the run record closes; at most
:data:`LIVE` pairs stay pending.  On a CPU device they are not recorded.

**Run records.**  Each ``Simulator_M.run()`` and ``Simulator_TM.run()``
leaves one dict in
:data:`runs` (newest last): ``start_ns``, ``end_ns``, converged ``steps``,
``cuda``, ``completed``, ``spans`` ({name: {count, total_ns, self_ns}} of
the run), ``gaps`` ({cause: ns}), ``counters`` (deltas of the equation's
counters: graph replays and captures, hand-kernel launches, fixed-point and
Krylov iterations, tangent builds, rollbacks, accepted float32 sweeps,
Mohr-Coulomb elements on the yield surface),
``captures`` (the keys of the graphs captured in the run), ``device``
({kind: [[step, ms], ...]}) and ``setup`` (the process-wide span and device
totals when the run started).

:func:`write_chrome` writes the ring as a Chrome/Perfetto trace on the
clock of ``torch.profiler`` (:data:`TRACER` ``.offset_ns``, taken at
import, converts), to open beside a profiler trace.  :func:`enable` turns
everything off and on; off, every hook is one flag test.

The module's functions (``enable``, ``begin``, ``end``, ``read``,
``enqueue``, ``dev_begin``, ``dev_end``, ``captured``,
``replay_end``, ``at_step``, ``take_walls``, ``open_run``, ``close_run``, ``totals``,
``count_of``, ``now``, ``write_chrome``) are the methods of the one
:class:`Tracer` of the process, :data:`TRACER`; :data:`runs` is its deque
of run records.
"""
from __future__ import annotations

import collections
import json
import os
import time

NAMES = ("run", "chunk", "step", "commit", "fixed_point", "sweep", "krylov",
         "save", "checkpoint", "read", "replay", "capture", "precond", "gap",
         "heat")
(RUN, CHUNK, STEP, COMMIT, FIXED_POINT, SWEEP, KRYLOV, SAVE, CHECKPOINT,
 READ, REPLAY, CAPTURE, PRECOND, GAP, HEAT) = range(len(NAMES))
NONE = len(NAMES)               # the cause of a gap outside every span
DEVICE_KINDS = ("tangent", "solve")

RING = 1 << 16                  # span slots
RUNS = 256                      # run records kept
LIVE = 1024                     # pending device event pairs


def _clock_offset(clock):
    """``time.time_ns() - clock()``, from the closest of five brackets:
    the shift from ``clock`` to the wall clock that torch.profiler's
    timestamps use."""
    best = None
    for _ in range(5):
        a = clock()
        wall = time.time_ns()
        b = clock()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


class Tracer:
    """Spans, gaps, device spans and run records on ``clock`` (ns)."""

    def __init__(self, clock=time.perf_counter_ns, ring=RING, offset_ns=None):
        self.clock = clock
        self.offset_ns = (_clock_offset(clock) if offset_ns is None
                          else offset_ns)
        self.size = ring
        self.runs = collections.deque(maxlen=RUNS)
        self.on = True
        self._pool = []
        n = len(NAMES)
        self.ring = [None] * self.size
        self.written = 0
        self.stack = []                 # [name, t0, child ns, step]
        self.heat_open = 0               # open heat spans: they keep gaps
        self.count, self.total, self.self_ns = [0] * n, [0] * n, [0] * n
        self.gap_ns = [0] * (n + 1)     # by cause; NONE outside spans
        self.gap_t0 = None               # the open gap's start
        self.gap_mark = 0                # its last cut
        self.gap_cause = NONE
        self.step = 0
        self.walls = collections.deque(maxlen=RUNS)
        self.dev_count = dict.fromkeys(DEVICE_KINDS, 0)
        self.dev_ms = dict.fromkeys(DEVICE_KINDS, 0.0)
        self.pending = collections.deque()   # (kind, step, run, pair)
        self.run = None
        self.serial = 0

    # -- the switch ---------------------------------------------------- #
    def enable(self, flag=True):
        """Turn recording on (the default) or off; off closes any open
        gap and drops the open spans."""
        self.on = bool(flag)
        if not self.on:
            self.gap_t0 = None
            self.stack.clear()
            self.heat_open = 0
            self.run = None

    # -- spans --------------------------------------------------------- #
    def now(self):
        """The tracer's clock, in nanoseconds."""
        return self.clock()

    def at_step(self, step):
        """The time step the spans opened from now on belong to."""
        self.step = step

    def begin(self, name):
        """Open span ``name`` (an index into :data:`NAMES`)."""
        if not self.on:
            return
        t = self.clock()
        if self.gap_t0 is not None:
            self._cut(t)
        self.stack.append([name, t, 0, self.step])
        self.heat_open += name == HEAT

    def end(self, name):
        """Close the innermost open span ``name``, and any left open
        inside it; a ``name`` not open is ignored."""
        if not self.on:
            return
        t = self.clock()
        st = self.stack
        if not st or st[-1][0] != name:
            if not any(s[0] == name for s in st):
                return
            while st[-1][0] != name:    # spans left open by an exception
                self.end(st[-1][0])
        if self.gap_t0 is not None:
            self._cut(t)
        n, t0, child, step = st.pop()
        self.heat_open -= n == HEAT
        d = t - t0
        self._put(n, t0, t, d - child, step)
        if n == STEP:
            self.walls.append(d)
            if self.pending:
                self.resolve()

    def _put(self, n, t0, t1, own, step):
        """Count a closed span and keep it in the ring."""
        d = t1 - t0
        self.count[n] += 1
        self.total[n] += d
        self.self_ns[n] += own
        st = self.stack
        if st:
            st[-1][2] += d
            parent = st[-1][0]
        else:
            parent = NONE
        self.ring[self.written % self.size] = (n, t0, t1, parent, step)
        self.written += 1
        return parent

    def take_walls(self):
        """The lengths (ns) of the ``step`` spans closed since the last
        call (the newest :data:`RUNS`)."""
        out = list(self.walls)
        self.walls.clear()
        return out

    # -- reads and gaps ------------------------------------------------ #
    def read(self, t):
        """``t.tolist()``, counted and spanned as one host read; a CUDA
        read closes an open gap and opens one when it returns."""
        if not self.on:
            return t.tolist()
        cuda = t.is_cuda
        t0 = self.clock()
        if self.gap_t0 is not None:
            if cuda:
                self._close_gap(t0)
            else:
                self._cut(t0)
        out = t.tolist()
        t1 = self.clock()
        self._put(READ, t0, t1, t1 - t0, self.step)
        if cuda:
            self.gap_t0 = self.gap_mark = t1
            self.gap_cause = self._holder()
        elif self.gap_t0 is not None:
            self.gap_ns[READ] += t1 - self.gap_mark
            self.gap_mark = t1
        return out

    def enqueue(self):
        """Device work was just queued: close an open gap."""
        if self.gap_t0 is not None:
            self._close_gap(self.clock())

    def replay_end(self):
        """Close the ``replay`` span: the graph is launched, so an open
        gap ends here (its last piece, the launch, is the replay's)."""
        if self.on and self.gap_t0 is not None and self.stack \
                and self.stack[-1][0] == REPLAY:
            self._close_gap(self.clock())
        self.end(REPLAY)

    def _holder(self):
        """The cause of a gap now: an open ``heat`` span, else the
        innermost open span, else none."""
        if self.heat_open:
            return HEAT
        return self.stack[-1][0] if self.stack else NONE

    def _open_gap(self, t):
        self.gap_t0 = self.gap_mark = t
        self.gap_cause = self._holder()

    def _cut(self, t):
        self.gap_ns[self._holder()] += t - self.gap_mark
        self.gap_mark = t

    def _close_gap(self, t):
        self._cut(t)
        self.ring[self.written % self.size] = (GAP, self.gap_t0, t,
                                               self.gap_cause, self.step)
        self.written += 1
        self.count[GAP] += 1
        self.total[GAP] += t - self.gap_t0
        self.gap_t0 = None

    # -- device spans -------------------------------------------------- #
    def dev_begin(self, device):
        """A started event pair on a CUDA ``device``; None elsewhere."""
        if not self.on or device.type != "cuda":
            return None
        if self._pool:
            pair = self._pool.pop()
        else:
            import torch
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        pair[0].record()
        return pair

    def dev_end(self, kind, pair):
        """Close ``pair`` (from :meth:`dev_begin`) as a ``kind`` span."""
        if pair is None:
            return
        pair[1].record()
        self.pending.append((kind, self.step, self.serial, pair))
        if len(self.pending) > LIVE:
            self.resolve(block=1)

    def resolve(self, block=0):
        """Resolve the pending event pairs that are complete, oldest
        first, waiting for the oldest ``block`` of them."""
        q = self.pending
        while q:
            kind, step, serial, pair = q[0]
            if block > 0:
                pair[1].synchronize()
                block -= 1
            elif not pair[1].query():
                return
            q.popleft()
            ms = pair[0].elapsed_time(pair[1])
            self._pool.append(pair)
            self.dev_count[kind] += 1
            self.dev_ms[kind] += ms
            if self.run is not None and serial == self.serial:
                self.run["device"][kind].append([step, ms])

    # -- captures ------------------------------------------------------ #
    def captured(self, key):
        """A graph was captured under ``key``."""
        if self.on and self.run is not None:
            self.run["captures"].append(repr(key))

    # -- run records --------------------------------------------------- #
    def totals(self):
        """The process-wide totals: {"spans": {name: {count, total_ns,
        self_ns}}, "gaps": {cause: ns}, "device": {kind: {count, ms}}}."""
        return {"spans": {NAMES[i]: {"count": self.count[i],
                                     "total_ns": self.total[i],
                                     "self_ns": self.self_ns[i]}
                          for i in range(len(NAMES))},
                "gaps": {_cause(i): v for i, v in enumerate(self.gap_ns)
                         if v},
                "device": {k: {"count": self.dev_count[k],
                               "ms": self.dev_ms[k]} for k in DEVICE_KINDS}}

    def count_of(self, name):
        """How many ``name`` spans closed in this process."""
        return self.count[NAMES.index(name)]

    def open_run(self, counters=None, cuda=False):
        """Start a run record; ``counters()`` gives the counters whose
        deltas it keeps.  A run on CUDA opens a gap."""
        if not self.on:
            return
        if self.pending:
            self.resolve(block=len(self.pending))
        self.serial += 1
        self.stack.clear()
        self.heat_open = 0
        self.gap_t0 = None
        setup = self.totals()
        self.run = {"setup": setup, "counters": counters,
                    "at_start": counters() if counters else {},
                    "base": (list(self.count), list(self.total),
                             list(self.self_ns), list(self.gap_ns)),
                    "captures": [], "cuda": bool(cuda),
                    "device": {k: [] for k in DEVICE_KINDS}}
        self.begin(RUN)
        self.run["start_ns"] = self.stack[-1][1]
        if cuda:
            self._open_gap(self.run["start_ns"])

    def close_run(self, steps, completed=True):
        """End the run record with its converged ``steps`` and keep it in
        :attr:`runs`."""
        run = self.run
        if not self.on or run is None:
            return
        self.end(RUN)
        t = self.ring[(self.written - 1) % self.size][2]
        if self.gap_t0 is not None:
            self._close_gap(t)
        self.resolve(block=len(self.pending))
        c0, t0, s0, g0 = run.pop("base")
        counters = run.pop("counters")
        before = run.pop("at_start")
        after = counters() if counters else {}
        self.run = None
        self.runs.append({
            "start_ns": run["start_ns"], "end_ns": t, "steps": steps,
            "cuda": run["cuda"],
            "completed": completed,
            "spans": {NAMES[i]: {"count": self.count[i] - c0[i],
                                 "total_ns": self.total[i] - t0[i],
                                 "self_ns": self.self_ns[i] - s0[i]}
                      for i in range(len(NAMES))
                      if self.count[i] != c0[i]},
            "gaps": {_cause(i): v - g0[i]
                     for i, v in enumerate(self.gap_ns) if v != g0[i]},
            "counters": {k: after[k] - before.get(k, 0) for k in after},
            "captures": run["captures"], "device": run["device"],
            "setup": run["setup"]})

    # -- export -------------------------------------------------------- #
    def spans(self):
        """The ring's spans, oldest first: (name, start_ns, end_ns, parent
        or gap cause, step), on the tracer's clock."""
        n = min(self.written, self.size)
        first = self.written - n
        return [self.ring[(first + i) % self.size] for i in range(n)]

    def write_chrome(self, path, since_ns=None):
        """Write the ring (the spans that end after ``since_ns``, on the
        tracer's clock, when given) as a Chrome/Perfetto trace (``X``
        events, ts in microseconds on the profiler's clock): host spans on
        one track, gaps on another, each with its step and parent or
        cause."""
        pid, off = os.getpid(), self.offset_ns
        events = [{"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                   "args": {"name": label}}
                  for tid, label in ((1, "safeincave_torch spans"),
                                     (2, "safeincave_torch gaps"))]
        for n, t0, t1, rel, step in self.spans():
            if since_ns is not None and t1 < since_ns:
                continue
            gap = n == GAP
            events.append({"ph": "X", "pid": pid, "tid": 2 if gap else 1,
                           "name": NAMES[n], "ts": (t0 + off) / 1e3,
                           "dur": (t1 - t0) / 1e3,
                           "args": {"step": step,
                                    "cause" if gap else "parent":
                                        _cause(rel)}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def _cause(i):
    return NAMES[i] if i < len(NAMES) else "none"


TRACER = Tracer()
runs = TRACER.runs

enable = TRACER.enable
now = TRACER.now
at_step = TRACER.at_step
begin = TRACER.begin
end = TRACER.end
read = TRACER.read
enqueue = TRACER.enqueue
replay_end = TRACER.replay_end
dev_begin = TRACER.dev_begin
dev_end = TRACER.dev_end
captured = TRACER.captured
take_walls = TRACER.take_walls
open_run = TRACER.open_run
close_run = TRACER.close_run
totals = TRACER.totals
count_of = TRACER.count_of
write_chrome = TRACER.write_chrome


def enabled():
    """Whether recording is on."""
    return TRACER.on
