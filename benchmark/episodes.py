"""Set-up, episodes and the measured window of one cell, on the program.

A cell names a configuration (``configs/<name>.json`` with its builder
``configs/<name>.py``) and a traffic mix (``traffic/<name>.json``).  The
set-up builds the configuration, runs its warm stages to the episode's
start, saves that state once through the program's ``save_checkpoint``,
and runs one episode outside the window, so that every graph and kernel
the episodes use is captured and built.  Each episode restores the state
(``load_checkpoint``, clock stopped) and runs the traffic's steps with the
traffic's ``SaveFields``; its clock runs from ``run()``'s start to its
return and a ``torch.cuda.synchronize()``.

A builder's ``build`` returns the momentum equation, or the pair (momentum
equation, heat equation) of a coupled configuration; ``warm`` takes what
``build`` returned.  A momentum equation alone runs through
``Simulator_M.run()`` with the traffic's checkpoint cadence and
``StepMetrics``; a pair runs through ``Simulator_TM.run()``, whose state
and checkpoints carry the heat field and which takes neither a checkpoint
cadence nor ``StepMetrics`` (a traffic that asks for one fails the run).
A field the momentum equation lacks is saved from the heat equation.

Instrumentation from the benchmark's side (frozen copies, named where they
stand): the equations' step calls are wrapped at class level to record the
fixed-point, Krylov and heat CG counts of every call (and, traced, the host
seconds inside them); saves are stamped; traced runs add ``StepClock``
(CUDA events around the tangent builds, linear solves and heat steps),
``counting_reads`` and the save and checkpoint times.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import time

import numpy as np
import torch

import safeincave_torch as sc
import safeincave_torch.simulators as simulators
from safeincave_torch.checkpoint import load_checkpoint, save_checkpoint
from safeincave_torch.fem.heat import HeatDiffusion
from safeincave_torch.fem.momentum import LinearMomentum

from spec import BENCH, load_json, load_module, start_hours  # noqa: F401


# --------------------------------------------------------------------------- #
# instrumentation
# --------------------------------------------------------------------------- #
class Recorder:
    """Wraps ``LinearMomentum.solve_time_steps``, ``solve_tm_time_steps``,
    ``solve_time_step`` and ``commit_time_step`` and ``HeatDiffusion.solve``
    at class level (an instance attribute would turn the simulators' fused
    chunks off).  Each call that no other wrapped call encloses appends its
    counts to ``calls``: ("fused", rows), ("tm", rows), ("step",
    iterations, error, Krylov iterations), ("commit",) or ("heat", CG
    iterations).  With ``timed`` it synchronises after each such call and
    adds its host seconds to ``seconds``.  The heat steps of a fused TM
    chunk (``HeatDiffusion.step``) are counted and timed in the chunk's."""

    NAMES = ((LinearMomentum, "solve_time_steps"),
             (LinearMomentum, "solve_tm_time_steps"),
             (LinearMomentum, "solve_time_step"),
             (LinearMomentum, "commit_time_step"),
             (HeatDiffusion, "solve"))

    def __init__(self, sync, timed=False):
        self.sync, self.timed = sync, timed
        self.calls, self.seconds = [], 0.0
        self._saved, self._depth = {}, 0

    def _record(self, name, obj, out):
        if name == "solve_time_steps":
            self.calls.append(("fused", np.asarray(out)))
        elif name == "solve_tm_time_steps":
            self.calls.append(("tm", np.asarray(out)))
        elif name == "solve_time_step":
            self.calls.append(("step", out[0], out[1], obj.krylov_total))
        elif name == "commit_time_step":
            self.calls.append(("commit",))
        else:
            self.calls.append(("heat", int(obj.solver_stats[0])))

    def _wrap(self, name, real):
        rec = self

        def call(obj, *args, **kw):
            if rec._depth:
                return real(obj, *args, **kw)
            t0 = time.perf_counter()
            rec._depth += 1
            try:
                out = real(obj, *args, **kw)
            finally:
                rec._depth -= 1
            if rec.timed:
                rec.sync()
                rec.seconds += time.perf_counter() - t0
            rec._record(name, obj, out)
            return out
        return call

    def __enter__(self):
        for cls, name in self.NAMES:
            self._saved[cls, name] = getattr(cls, name)
            setattr(cls, name, self._wrap(name, self._saved[cls, name]))
        return self

    def __exit__(self, *exc):
        for (cls, name), real in self._saved.items():
            setattr(cls, name, real)

    def take(self):
        """(calls, seconds) since the last take."""
        out = (self.calls, self.seconds)
        self.calls, self.seconds = [], 0.0
        return out


def counts(calls):
    """{"steps", "fp", "krylov", "heat_cg", "work"} of recorded calls:
    converged steps, fixed-point, Krylov and heat CG iterations (None when
    no heat step ran) and the work signature."""
    steps = fp = kry = 0
    heat = None
    sig = []
    for c in calls:
        if c[0] == "fused":
            rows = c[1]
            steps += int((rows[:, 5] > 0.5).sum())
            fp += int(rows[:, 0].sum())
            kry += int(rows[:, 2].sum())
            sig.append(("fused", rows[:, [0, 2, 5]].tolist()))
        elif c[0] == "tm":
            # [heat_iters, heat_res, fp_iters, error, krylov_total, converged]
            rows = c[1]
            steps += int((rows[:, 5] > 0.5).sum())
            fp += int(rows[:, 2].sum())
            kry += int(rows[:, 4].sum())
            heat = (heat or 0) + int(rows[:, 0].sum())
            sig.append(("tm", rows[:, [0, 2, 4, 5]].tolist()))
        elif c[0] == "step":
            fp += int(c[1])
            kry += int(c[3])
            sig.append(("step", int(c[1]), int(c[3])))
        elif c[0] == "heat":
            heat = (heat or 0) + c[1]
            sig.append(("heat", c[1]))
        else:
            steps += 1
    return {"steps": steps, "fp": fp, "krylov": kry, "heat_cg": heat,
            "work": sig}


class StampedSaves(sc.SaveFields):
    """``SaveFields`` that stamps the host clock after each kept save; with
    ``timed`` (a copy of chip_smoke.py's ``timed_saves``) it synchronises
    first and keeps each kept save's host seconds."""

    def __init__(self, eq, save_every, sync, timed=False):
        super().__init__(eq, save_every=save_every)
        self.sync, self.timed = sync, timed
        self.stamps, self.seconds = [], []

    def save_fields(self, t):
        if self._call_count % self.save_every:
            return super().save_fields(t)
        if self.timed:
            self.sync()
        t0 = time.perf_counter()
        super().save_fields(t)
        now = time.perf_counter()
        self.stamps.append(now)
        if self.timed:
            self.seconds.append(now - t0)


@contextlib.contextmanager
def timed_checkpoints(sync, seconds):
    """While active, ``Simulator_M``'s checkpoints add their host seconds,
    from a sync to the end of the write, to ``seconds``."""
    real = simulators.save_checkpoint

    def timed(*args, **kw):
        sync()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return out
    simulators.save_checkpoint = timed
    try:
        yield
    finally:
        simulators.save_checkpoint = real


class StepClock:
    """A copy of chip_smoke.py's ``StepClock``: CUDA events around every
    call of an equation's tangent suite and linear solves (the f64 solve
    and the f32 sweep's), and of a heat equation's steps."""

    def __init__(self, eq, heat=None):
        self.eq, self.heat = eq, heat
        self.spans = {"tangent": [], "solve": [], "heat": []}
        sweep = eq.solver.fp32_enabled(eq.device)
        self.solvers = (eq._get_solver(),
                        eq._get_solve32() if sweep else eq._solve32)

        def timed(kind, fn):
            def call(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                stop.record()
                self.spans[kind].append((start, stop))
                return out
            return call

        eq._tangent = timed("tangent", eq._tangent)
        eq._solve_lin = timed("solve", self.solvers[0])
        if sweep:
            eq._solve32 = timed("solve", self.solvers[1])
        if heat is not None:
            heat.step = timed("heat", heat.step)

    def close(self):
        """Unwrap the equations: their own tangent suite, solvers and heat
        step again."""
        del self.eq._tangent
        self.eq._solve_lin, self.eq._solve32 = self.solvers
        if self.heat is not None:
            del self.heat.step

    def take(self):
        """{kind: [ms per call]} since the last take."""
        torch.cuda.synchronize()
        out = {k: [a.elapsed_time(b) for a, b in v]
               for k, v in self.spans.items()}
        for v in self.spans.values():
            v.clear()
        return out


_READS = ("item", "tolist", "__float__", "__int__", "__bool__")


@contextlib.contextmanager
def counting_reads():
    """A frozen copy of safeincave_torch/fem/graphs.py's ``counting_reads``:
    counts the host reads of tensors while the block runs (a read made
    inside another counts once).  Yields a one-element list."""
    n, depth = [0], [0]
    saved = {name: getattr(torch.Tensor, name) for name in _READS}

    def counted(f):
        def read(self, *args, **kw):
            n[0] += depth[0] == 0
            depth[0] += 1
            try:
                return f(self, *args, **kw)
            finally:
                depth[0] -= 1
        return read

    for name, f in saved.items():
        setattr(torch.Tensor, name, counted(f))
    try:
        yield n
    finally:
        for name, f in saved.items():
            setattr(torch.Tensor, name, f)


# --------------------------------------------------------------------------- #
# the cell
# --------------------------------------------------------------------------- #
class Cell:
    """One workload of BENCHMARK.json on the program."""

    def __init__(self, cell, seed, device, root, work_dir, mesh_dir=None):
        self.name = cell["name"]
        self.cfg = load_json("configs", f"{cell['config']}.json")
        self.traffic = load_json("traffic", f"{cell['traffic']}.json")
        self.builder = load_module(
            os.path.join(BENCH, "configs", f"{cell['config']}.py"),
            f"bench_config_{cell['config']}")
        self.device = torch.device(device)
        self.root, self.work = root, work_dir
        self.mesh_dir = mesh_dir or os.path.join(root, "grids",
                                                 self.cfg["mesh"]["grid"])
        self.start_h = start_hours(self.cfg, seed)
        tr = self.traffic
        self.end_h = self.start_h + tr["steps"] * tr["dt_h"]
        self.warm_path = os.path.join(work_dir, "warm.npz")
        self.episodes = 0
        self.heat = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        """Build, warm up to the start, save the state; ``phases`` keeps
        the host seconds of each part."""
        t0 = time.perf_counter()
        built = self.builder.build(self.cfg, self.mesh_dir, self.device)
        self.eq, self.heat = built if isinstance(built, tuple) \
            else (built, None)
        if self.heat is not None:
            tr = self.traffic
            if tr["checkpoint_every"] or tr["step_metrics"]:
                raise ValueError(
                    f"{self.name}: Simulator_TM takes no checkpoint cadence "
                    f"and no StepMetrics; traffic {tr['name']!r} asks for "
                    f"checkpoint_every={tr['checkpoint_every']}, "
                    f"step_metrics={tr['step_metrics']}")
        self.sync()
        t1 = time.perf_counter()
        tc = self.builder.warm(built, self.cfg, self.traffic["dt_h"],
                               self.start_h, self.root)
        self.sync()
        t2 = time.perf_counter()
        save_checkpoint(self.warm_path, self.eq, tc, heat_eq=self.heat)
        self.sync()
        self.phases = {"build": t1 - t0, "warm": t2 - t1,
                       "save": time.perf_counter() - t2}

    def _outputs(self, out_dir, timed):
        """The traffic's stamped saves: one ``SaveFields`` on the momentum
        equation, and on a coupled cell one on the heat equation for the
        fields the momentum equation lacks."""
        eq, heat, tr = self.eq, self.heat, self.traffic
        outs = {}
        for name, label in tr["fields"]:
            owner = heat if heat is not None and not hasattr(eq, name) \
                else eq
            if id(owner) not in outs:
                outs[id(owner)] = StampedSaves(owner, tr["save_every"],
                                               self.sync, timed)
                outs[id(owner)].set_output_folder(out_dir)
            outs[id(owner)].add_output_field(name, label)
        return list(outs.values())

    def _simulator(self, tc, outs, out_dir):
        eq, tr = self.eq, self.traffic
        if self.heat is not None:
            return sc.Simulator_TM(eq, self.heat, tc, outs,
                                   compute_elastic_response=False)
        metrics = (sc.StepMetrics(os.path.join(out_dir, "metrics.jsonl"))
                   if tr["step_metrics"] else None)
        return sc.Simulator_M(eq, tc, outs, compute_elastic_response=False,
                              metrics=metrics,
                              checkpoint_every=tr["checkpoint_every"],
                              checkpoint_path=os.path.join(out_dir,
                                                           "checkpoint.npz"))

    def episode(self, rec, timed=False):
        """One episode from the saved state; returns its record.  The
        previous episode's outputs are removed first."""
        eq, tr = self.eq, self.traffic
        old = os.path.join(self.work, f"episode{self.episodes - 1}")
        shutil.rmtree(old, ignore_errors=True)
        out_dir = os.path.join(self.work, f"episode{self.episodes}")
        self.episodes += 1
        tc = sc.TimeController(dt=tr["dt_h"], initial_time=0.0,
                               final_time=self.end_h, time_unit="hour")
        load_checkpoint(self.warm_path, eq, tc, heat_eq=self.heat)
        outs = self._outputs(out_dir, timed)
        sim = self._simulator(tc, outs, out_dir)
        ckpt_s = []
        guard = timed_checkpoints(self.sync, ckpt_s) if timed \
            else contextlib.nullcontext()
        rec.take()
        with guard:
            self.sync()
            t0 = time.perf_counter()
            sim.run()
            self.sync()
            secs = time.perf_counter() - t0
        calls, inside = rec.take()
        n = counts(calls)
        return {"seconds": secs, "steps": n["steps"],
                "attempted": tc.step_counter - round(self.start_h
                                                     / tr["dt_h"]),
                "fp": n["fp"], "krylov": n["krylov"],
                "heat_cg": n["heat_cg"], "work": n["work"],
                "out_dir": out_dir,
                "stamps": sorted(s for o in outs for s in o.stamps),
                "save_s": [s for o in outs for s in o.seconds] + ckpt_s,
                "solve_s": inside}
