"""Set-up, episodes and the measured window of one cell, on the program.

A cell names a configuration (``configs/<name>.json`` with its builder
``configs/<name>.py``) and a traffic mix (``traffic/<name>.json``).  The
set-up builds the configuration, runs its warm stages through
``Simulator_M`` to the episode's start, saves that state once through the
program's ``save_checkpoint``, and runs one episode outside the window, so
that every graph and kernel the episodes use is captured and built.  Each
episode restores the state (``load_checkpoint``, clock stopped) and runs
the traffic's steps through ``Simulator_M.run()`` with the traffic's
``SaveFields``, checkpoint cadence and ``StepMetrics``; its clock runs from
``run()``'s start to its return and a ``torch.cuda.synchronize()``.

Instrumentation from the benchmark's side (frozen copies, named where they
stand): the equation's step calls are wrapped at class level to record the
fixed-point and Krylov counts of every call (and, traced, the host seconds
inside them); saves are stamped; traced runs add ``StepClock`` (CUDA events
around the tangent builds and linear solves), ``counting_reads`` and the
save and checkpoint times.
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
from safeincave_torch.fem.momentum import LinearMomentum

from spec import BENCH, load_json, load_module, start_hours  # noqa: F401


# --------------------------------------------------------------------------- #
# instrumentation
# --------------------------------------------------------------------------- #
class Recorder:
    """Wraps ``LinearMomentum.solve_time_steps``, ``solve_time_step`` and
    ``commit_time_step`` at class level (an instance attribute would turn
    ``Simulator_M``'s fused chunks off).  Each call appends its counts to
    ``calls``: ("fused", rows) or ("step", iterations, error, Krylov
    iterations) or ("commit",).  With ``timed`` it synchronises after each
    call and adds its host seconds to ``seconds``."""

    NAMES = ("solve_time_steps", "solve_time_step", "commit_time_step")

    def __init__(self, sync, timed=False):
        self.sync, self.timed = sync, timed
        self.calls, self.seconds = [], 0.0
        self._saved = {}

    def _wrap(self, name, real):
        rec = self

        def call(eq, *args, **kw):
            t0 = time.perf_counter()
            out = real(eq, *args, **kw)
            if rec.timed:
                rec.sync()
                rec.seconds += time.perf_counter() - t0
            if name == "solve_time_steps":
                rec.calls.append(("fused", np.asarray(out)))
            elif name == "solve_time_step":
                rec.calls.append(("step", out[0], out[1], eq.krylov_total))
            else:
                rec.calls.append(("commit",))
            return out
        return call

    def __enter__(self):
        for name in self.NAMES:
            self._saved[name] = getattr(LinearMomentum, name)
            setattr(LinearMomentum, name, self._wrap(name, self._saved[name]))
        return self

    def __exit__(self, *exc):
        for name, real in self._saved.items():
            setattr(LinearMomentum, name, real)

    def take(self):
        """(calls, seconds) since the last take."""
        out = (self.calls, self.seconds)
        self.calls, self.seconds = [], 0.0
        return out


def counts(calls):
    """(converged steps, fixed-point iterations, Krylov iterations, the
    work signature) of recorded calls."""
    steps = fp = kry = 0
    sig = []
    for c in calls:
        if c[0] == "fused":
            rows = c[1]
            steps += int((rows[:, 5] > 0.5).sum())
            fp += int(rows[:, 0].sum())
            kry += int(rows[:, 2].sum())
            sig.append(("fused", rows[:, [0, 2, 5]].tolist()))
        elif c[0] == "step":
            fp += int(c[1])
            kry += int(c[3])
            sig.append(("step", int(c[1]), int(c[3])))
        else:
            steps += 1
    return steps, fp, kry, sig


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
    and the f32 sweep's)."""

    def __init__(self, eq):
        self.eq, self.spans = eq, {"tangent": [], "solve": []}
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

    def close(self):
        """Unwrap the equation: its own tangent suite and solvers again."""
        del self.eq._tangent
        self.eq._solve_lin, self.eq._solve32 = self.solvers

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

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        """Build, warm up to the start, save the state; ``phases`` keeps
        the host seconds of each part."""
        t0 = time.perf_counter()
        self.eq = self.builder.build(self.cfg, self.mesh_dir, self.device)
        self.sync()
        t1 = time.perf_counter()
        tc = self.builder.warm(self.eq, self.cfg, self.traffic["dt_h"],
                               self.start_h, self.root)
        self.sync()
        t2 = time.perf_counter()
        save_checkpoint(self.warm_path, self.eq, tc)
        self.sync()
        self.phases = {"build": t1 - t0, "warm": t2 - t1,
                       "save": time.perf_counter() - t2}

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
        load_checkpoint(self.warm_path, eq, tc)
        out = StampedSaves(eq, tr["save_every"], self.sync, timed)
        out.set_output_folder(out_dir)
        for name, label in tr["fields"]:
            out.add_output_field(name, label)
        metrics = (sc.StepMetrics(os.path.join(out_dir, "metrics.jsonl"))
                   if tr["step_metrics"] else None)
        sim = sc.Simulator_M(eq, tc, [out], compute_elastic_response=False,
                             metrics=metrics,
                             checkpoint_every=tr["checkpoint_every"],
                             checkpoint_path=os.path.join(out_dir,
                                                          "checkpoint.npz"))
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
        steps, fp, kry, sig = counts(calls)
        return {"seconds": secs, "steps": steps,
                "attempted": tc.step_counter - round(self.start_h
                                                     / tr["dt_h"]),
                "fp": fp, "krylov": kry, "work": sig, "out_dir": out_dir,
                "stamps": out.stamps, "save_s": out.seconds + ckpt_s,
                "solve_s": inside}
