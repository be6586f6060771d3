"""Simulation drivers (port of ``safeincave_tpu/simulators.py``).

* ``Simulator_M``: theta-scheme time loop over a momentum equation with
  fixed-point iteration (tol 1e-8, <= 40 iterations), dt-halving retry
  (<= 3) with a full state snapshot and restore on divergence or NaN, a
  diagnostic dump after exhausted retries, and commit only if converged.
  Between output and checkpoint boundaries the steps run as fused chunks
  through ``LinearMomentum.solve_time_steps``; a step that fails inside a
  chunk rewinds to the per-step retry flow.
* ``Simulator_Mout``: the same loop without dt-retry.
* ``Simulator_TM``: the same loop with a heat step before each momentum
  step (tol 1e-6, <= 20 iterations, one-way temperature coupling).  It
  overrides hooks of ``Simulator_M``: the run's start (``T0`` from the
  heat field), the chunk call (``solve_tm_time_steps``), the step's
  backup (with the heat field) and one attempt (heat step first); it has
  no metrics, checkpoints, dt feedback or diagnostic dump.
* ``Simulator_T``: the heat-only loop, fused between output boundaries
  through ``HeatDiffusion.solve_steps``.
"""
from __future__ import annotations

import os
import sys
from abc import ABC, abstractmethod

import numpy as np

from . import tracing
from .checkpoint import save_checkpoint
from .fem.momentum import LinearMomentumBase
from .metrics import StepMetrics
from .output.screen import ScreenPrinter
from .utils import is_main_process, to_numpy, voigt_to_tensor


class Simulator(ABC):
    @abstractmethod
    def run(self):
        ...


def _planned_steps(tc, chunk):
    """Advance ``tc`` over up to ``chunk`` steps; returns (ts, dts)."""
    ts, dts = [], []
    while tc.keep_looping() and len(ts) < chunk:
        tc.advance_time()
        ts.append(tc.t)
        dts.append(tc.dt)
    return ts, dts


def _keeps(output):
    """Whether ``output``'s next ``save_fields`` call writes."""
    fn = getattr(output, "calls_until_next_keep", None)
    return fn is None or fn() == 1


def _output_cap(outputs, cap):
    """``cap`` cut to the next save of every output; 1 when an output
    cannot say when it saves next."""
    for output in outputs:
        fn = getattr(output, "calls_until_next_keep", None)
        if fn is None:
            return 1
        cap = min(cap, fn())
    return max(int(cap), 1)


class Simulator_M(Simulator):
    """Mechanics-only driver with dt-halving retry."""

    def __init__(self, eq_mom, t_control, outputs,
                 compute_elastic_response: bool = True,
                 metrics: StepMetrics | None = None,
                 checkpoint_every: int = 0,
                 checkpoint_path: str = "checkpoint.npz",
                 fused_steps: int | str = "auto"):
        self.eq_mom = eq_mom
        self.t_control = t_control
        self.outputs = outputs
        self.compute_elastic_response = compute_elastic_response
        self.metrics = metrics
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = checkpoint_path
        self.fused_steps = fused_steps
        ScreenPrinter.reset_instance()
        self.screen = ScreenPrinter(eq_mom.grid, eq_mom.solver, eq_mom.mat,
                                    outputs, t_control.time_unit)

    # subclasses and scripts may override these
    tol = 1e-8
    maxiter = 40
    max_dt_cuts = 3
    # the equation's chunk method; its rows' (iterations, error) columns
    _chunk_method = "solve_time_steps"
    _screen_columns = (0, 1)

    # ------------------------------------------------------------------ #
    def _plan_chunk_size(self) -> int:
        """Steps to advance in one fused chunk (:meth:`_solve_chunk`).

        The host needs the fields only at output and checkpoint boundaries,
        so between them the steps run fused.  Per-step stats still surface,
        writes land on the same steps, and a non-converged step hands back
        its entry state for the dt-retry.  Returns 1 (the per-step flow)
        wherever fusing would change what a caller observes: a user hook on
        the equation, an instance-level wrapper of the step, an output
        without ``calls_until_next_keep``, or an output that writes on the
        next call."""
        cap = self.fused_steps
        if cap == "auto":
            # an adaptive controller changes dt only at chunk boundaries
            cap = 64 if self._feedback() is None else 4
        if not cap or cap <= 1 or not self._fusable():
            return 1
        cap = _output_cap(self.outputs, cap)
        if self.checkpoint_every:
            s0 = self.t_control.step_counter
            cap = min(cap, self.checkpoint_every
                      - s0 % self.checkpoint_every)
        return max(int(cap), 1)

    def _fusable(self) -> bool:
        """No user hook on the equation and no instance-level wrapper of
        its step or its chunk method."""
        eq = self.eq_mom
        return (hasattr(eq, self._chunk_method)
                and type(eq).run_after_solve
                is LinearMomentumBase.run_after_solve
                and "solve_time_step" not in eq.__dict__
                and self._chunk_method not in eq.__dict__)

    def _feedback(self):
        """The time controller's ``feedback`` (an adaptive dt), or None."""
        return getattr(self.t_control, "feedback", None)

    def _solve_chunk(self, ts, dts):
        """The fused steps ``ts``, ``dts``; returns their rows."""
        return self.eq_mom.solve_time_steps(ts, dts, tol=self.tol,
                                            maxiter=self.maxiter)

    def _run_fused_chunk(self, chunk: int) -> bool:
        """Advance up to ``chunk`` steps through one :meth:`_solve_chunk`.

        Returns True when every planned step converged (outputs, metrics,
        screen rows and checkpoints accounted for).  Returns False when a
        step failed: the equations then hold that step's entry state and
        the time controller is rewound, so the per-step dt-retry flow
        re-attempts exactly that step."""
        tc = self.t_control
        s0, t0 = tc.step_counter, tc.t
        ts, dts = _planned_steps(tc, chunk)
        if not ts:
            return True
        tracing.at_step(s0 + 1)
        tracing.take_walls()
        t_wall0 = tracing.now()
        stats = self._solve_chunk(ts, dts)
        chunk_wall = 1e-9 * (tracing.now() - t_wall0)
        walls = tracing.take_walls()
        conv = (stats[:, 5] > 0.5).astype(int)
        n_ok = int(conv.cumprod().sum())     # converged prefix length
        self._converged += n_ok
        col_it, col_err = self._screen_columns
        for k in range(n_ok):
            step_no = s0 + 1 + k
            if self.metrics is not None:
                # each step's own span (its share of the chunk's time when
                # tracing is off), flagged fused
                self.metrics.record(step_no, ts[k], dts[k],
                                    int(stats[k, 0]), float(stats[k, 1]),
                                    wall_s=1e-9 * walls[k]
                                    if k < len(walls)
                                    else chunk_wall / max(n_ok, 1),
                                    fused=True,
                                    converged=True, dt_cuts=0,
                                    krylov=int(stats[k, 3]),
                                    krylov_total=int(stats[k, 2]),
                                    lin_res=float(stats[k, 4]))
            current_time = "%.3f" % (ts[k] / tc.time_conversion)
            self.screen.print_row([
                step_no, dts[k] / tc.time_conversion,
                f"{current_time} / {tc.t_final / tc.time_conversion}",
                int(stats[k, col_it]), float(stats[k, col_err]),
            ])
        feedback = self._feedback()
        if n_ok and feedback is not None:
            # adapt the next chunk's dt from this chunk's mean fixed-point
            # work; a partial failure reports one cut, so the controller
            # shrinks before the retry re-attempts the failed step
            feedback(float(stats[:n_ok, 0].mean()),
                     dt_cuts=0 if n_ok == len(ts) else 1)
        if n_ok == len(ts):
            for output in self.outputs:
                output.skip_calls(n_ok - 1)
            self._save_derived_and_outputs(ts[-1])
            if (self.checkpoint_every
                    and tc.step_counter % self.checkpoint_every == 0):
                save_checkpoint(self.checkpoint_path, self.eq_mom, tc)
            return True
        # failed at planned step n_ok: account its predecessors' save calls
        # and rewind the controller to the failed step
        for output in self.outputs:
            output.skip_calls(n_ok)
        tc.step_counter = s0 + n_ok
        tc.t = ts[n_ok - 1] if n_ok else t0
        return False

    def run(self):
        """Run the time loop; one run record of
        :mod:`~safeincave_torch.tracing` spans it."""
        eq = self.eq_mom
        self._converged = 0
        tracing.at_step(self.t_control.step_counter)
        tracing.open_run(self._counters(), cuda=eq.device.type == "cuda")
        completed = False
        try:
            self._run()
            completed = True
        finally:
            tracing.close_run(self._converged, completed)

    def _counters(self):
        """What the run record keeps the deltas of: the momentum
        equation's ``counters()``, or None."""
        return getattr(self.eq_mom, "counters", None)

    def _start(self):
        """Open the outputs; then, unless the controller says a checkpoint
        restored a mid-run state (``step_counter > 0``: its committed rates
        must not be initialized again), the elastic response (if asked),
        the initial rates and the save at t = 0."""
        resumed = self.t_control.step_counter > 0
        for output in self.outputs:
            output.initialize()
        self._elastic(self.compute_elastic_response and not resumed)
        if not resumed:
            self._initial_rates()

    def _elastic(self, solve: bool):
        """The boundary conditions at the start time, then the elastic
        response (``solve``) or the strain of the current displacement."""
        eq, t = self.eq_mom, self.t_control.t
        eq.bc.update_dirichlet(t)
        eq.bc.update_neumann(t)
        if solve:
            eq.solve_elastic_response()
            eq.compute_elastic_stress(eq.compute_total_strain())
        else:
            eq.compute_total_strain()

    def _initial_rates(self):
        """The inelastic rates of the current stress, and the save at
        t = 0."""
        eq = self.eq_mom
        eq.compute_eps_ne_rate(eq.sig_v, self.t_control.t)
        eq.update_eps_ne_rate_old()
        self._save_derived_and_outputs(0.0)

    def _begin_step(self, t):
        """Back up what an attempt of the step at ``t`` changes (the fields
        ``solve_time_step`` reads, ``u`` its Krylov guess, and every
        element's state); returns the rollback.  The backups share the live
        tensors: a step replaces them and never writes into them."""
        eq = self.eq_mom
        sv, eps, u = eq.sig_v, eq.eps_tot_v, eq.u
        eq.save_internal_state()

        def restore():
            eq.sig_v, eq.eps_tot_v, eq.u = sv, eps, u
            eq._last_sv_k = sv
            eq.restore_internal_state()
        return restore

    def _attempt(self, t, dt):
        """One attempt of the step at ``t`` with ``dt``; returns
        (iterations, error)."""
        return self.eq_mom.solve_time_step(t, dt, tol=self.tol,
                                           maxiter=self.maxiter)

    def _run(self):
        eq = self.eq_mom
        tc = self.t_control
        self._start()

        while tc.keep_looping():
            chunk = self._plan_chunk_size()
            fused_failed = False
            if chunk > 1:
                if self._run_fused_chunk(chunk):
                    continue
                # the equations hold the failed step's entry state
                fused_failed = True
            # a chunk of 1, or a fused step that failed (tc rewound to it):
            # the per-step flow with dt-halving retry
            tc.advance_time()
            t, dt = tc.t, tc.dt
            tracing.at_step(tc.step_counter)
            restore = self._begin_step(t)

            dt_current = dt
            dt_cut = 0
            step_converged = False
            ite, error = 0, 2 * self.tol
            while not step_converged and dt_cut <= self.max_dt_cuts:
                # retries run pure f64 (no f32 sweep), so that a failure the
                # mixed-precision path caused is not repeated; so does the
                # first host attempt after a fused failure, which already
                # ran the f32 path from this exact state
                eq._fp32_disable = dt_cut > 0 or fused_failed
                ite, error = self._attempt(t, dt_current)
                if not np.isnan(error) and error <= self.tol:
                    step_converged = True
                    continue
                dt_cut += 1
                if dt_cut <= self.max_dt_cuts:
                    print(f"[SOLVER] Step {tc.step_counter}: "
                          f"{'NaN' if np.isnan(error) else 'no convergence'} "
                          f"after {ite} iters - halving dt, "
                          f"retry {dt_cut}/{self.max_dt_cuts}",
                          file=sys.stderr)
                    dt_current = dt_current / 2
                else:
                    self._dump_diagnostics(t, dt_current)
                restore()

            # give later direct solve_time_step calls and the next fused
            # chunk the f32 sweep back
            eq._fp32_disable = False

            if step_converged:
                self._converged += 1
                eq.commit_time_step(dt_current, eq.sig_v, eq._last_sv_k)
                feedback = self._feedback()
                if feedback is not None:
                    feedback(ite, dt_cuts=dt_cut)

            self._save_derived_and_outputs(t)
            if self.metrics is not None:
                self.metrics.record(tc.step_counter, t, dt_current, ite, error,
                                    converged=step_converged,
                                    dt_cuts=dt_cut,
                                    krylov=eq.solver_stats[0],
                                    krylov_total=eq.krylov_total,
                                    lin_res=eq.solver_stats[1])
            if (self.checkpoint_every
                    and tc.step_counter % self.checkpoint_every == 0):
                save_checkpoint(self.checkpoint_path, eq, tc)
            current_time = "%.3f" % (t / tc.time_conversion)
            self.screen.print_row([
                tc.step_counter,
                tc.dt / tc.time_conversion,
                f"{current_time} / {tc.t_final / tc.time_conversion}",
                ite,
                error,
            ])

        self.screen.close()
        if self.metrics is not None:
            self.metrics.close()
        for output in self.outputs:
            output.save_mesh()

    # ------------------------------------------------------------------ #
    def _save_derived_and_outputs(self, t):
        """The derived fields and every output's save call; a ``save`` span
        when an output writes."""
        kept = tracing.enabled() and any(map(_keeps, self.outputs))
        if kept:
            tracing.begin(tracing.SAVE)
        eq = self.eq_mom
        eq.compute_p_elems()
        eq.compute_q_elems()
        eq.compute_p_nodes()
        eq.compute_q_nodes()
        for output in self.outputs:
            output.save_fields(t)
        if kept:
            tracing.end(tracing.SAVE)

    def _dump_diagnostics(self, t, dt):
        """NaN diagnostic dump to ``nan_diagnostic.npz`` in the working
        directory, with the JAX package's keys (element arrays gathered
        from every rank of a multi-card run; rank 0 writes)."""
        eq = self.eq_mom
        g = eq.kernel.gather_elems
        diag = {
            "step": self.t_control.step_counter,
            "t": t,
            "dt": dt,
            "stress": to_numpy(voigt_to_tensor(g(eq.sig_v))),
            "eps_tot": to_numpy(voigt_to_tensor(g(eq.eps_tot_v))),
            "C_inv": to_numpy(g(eq.mat.C_inv)),
        }
        if hasattr(eq.mat, "G"):
            diag["G_total"] = to_numpy(g(eq.mat.G))
        for idx, e in enumerate(eq.mat.elems_ne):
            prefix = f"elem_{idx}_{e.name}"
            diag[f"{prefix}_eps_ne_rate"] = to_numpy(g(e.state["rate"]))
            diag[f"{prefix}_G"] = to_numpy(g(e.state["G"]))
            diag[f"{prefix}_B"] = to_numpy(g(e.state["B"]))
            for key in ("alpha", "qsi", "Fvp", "r", "h", "zeta"):
                if key in e.state:
                    diag[f"{prefix}_{key}"] = to_numpy(g(e.state[key]))
        if not is_main_process():
            return
        path = os.path.join(os.getcwd(), "nan_diagnostic.npz")
        np.savez(path, **diag)
        print(f"[SOLVER] All {self.max_dt_cuts} retries failed at step "
              f"{self.t_control.step_counter}. Diagnostic saved to {path}",
              file=sys.stderr)


class Simulator_Mout(Simulator_M):
    """Mechanics driver without dt-retry."""
    max_dt_cuts = 0


class Simulator_T(Simulator):
    """Thermal-only driver."""

    def __init__(self, eq_heat, t_control, outputs,
                 compute_elastic_response: bool = True,
                 fused_steps: int | str = "auto"):
        self.eq_heat = eq_heat
        self.t_control = t_control
        self.outputs = outputs
        self.fused_steps = fused_steps
        ScreenPrinter.reset_instance()
        self.screen = ScreenPrinter(eq_heat.grid, eq_heat.solver, eq_heat.mat,
                                    outputs, t_control.time_unit)

    def _plan_chunk_size(self) -> int:
        cap = 64 if self.fused_steps == "auto" else self.fused_steps
        if not cap or cap <= 1:
            return 1
        heat = self.eq_heat
        if not hasattr(heat, "solve_steps") or "solve" in heat.__dict__:
            return 1
        return _output_cap(self.outputs, cap)

    def run(self):
        tc = self.t_control
        for output in self.outputs:
            output.initialize()
        for output in self.outputs:
            output.save_fields(0)

        while tc.keep_looping():
            chunk = self._plan_chunk_size()
            if chunk > 1:
                s0 = tc.step_counter
                ts, dts = _planned_steps(tc, chunk)
                stats = self.eq_heat.solve_steps(ts, dts)
                for k in range(len(ts)):
                    current_time = "%.3f" % (ts[k] / tc.time_conversion)
                    self.screen.print_row([
                        s0 + 1 + k, dts[k] / tc.time_conversion,
                        f"{current_time} / "
                        f"{tc.t_final / tc.time_conversion}",
                        int(stats[k, 0]), float(stats[k, 1]),
                    ])
                for output in self.outputs:
                    output.skip_calls(len(ts) - 1)
                for output in self.outputs:
                    output.save_fields(ts[-1])
                continue
            tc.advance_time()
            t, dt = tc.t, tc.dt
            self.eq_heat.solve(t, dt)
            for output in self.outputs:
                output.save_fields(t)
            current_time = "%.3f" % (t / tc.time_conversion)
            self.screen.print_row([
                tc.step_counter, tc.dt / tc.time_conversion,
                f"{current_time} / {tc.t_final / tc.time_conversion}", 0, 0,
            ])

        self.screen.close()
        for output in self.outputs:
            output.save_mesh()


class Simulator_TM(Simulator_M):
    """One-way coupled thermo-mechanics on ``Simulator_M``'s loop."""

    tol = 1e-6
    maxiter = 20
    _chunk_method = "solve_tm_time_steps"
    _screen_columns = (2, 3)

    def __init__(self, eq_mom, eq_heat, t_control, outputs,
                 compute_elastic_response: bool = True,
                 fused_steps: int | str = "auto"):
        super().__init__(eq_mom, t_control, outputs,
                         compute_elastic_response, fused_steps=fused_steps)
        self.eq_heat = eq_heat

    def _fusable(self) -> bool:
        """Also no instance-level wrapper of the heat solve."""
        return super()._fusable() and "solve" not in self.eq_heat.__dict__

    def _feedback(self):
        """None: the coupled driver keeps its controller's dt."""

    def _solve_chunk(self, ts, dts):
        return self.eq_mom.solve_tm_time_steps(self.eq_heat, ts, dts,
                                               tol=self.tol,
                                               maxiter=self.maxiter)

    def _counters(self):
        """The momentum equation's counters and ``heat_replays``, the heat
        equation's graph replays."""
        base = super()._counters()
        heat = self.eq_heat
        if base is None or getattr(heat, "graphs", None) is None:
            return base
        return lambda: dict(base(), heat_replays=heat.graphs.replays)

    def _start(self):
        """Every run starts a stage: ``T0`` from the heat field around the
        elastic response, the initial rates and the save at t = 0."""
        eq, heat = self.eq_mom, self.eq_heat
        for output in self.outputs:
            output.initialize()
        eq.set_T0(heat.get_T_elems())
        self._elastic(self.compute_elastic_response)
        T_elems = heat.get_T_elems()
        eq.set_T(T_elems)
        eq.set_T0(T_elems)
        self._initial_rates()

    def _begin_step(self, t):
        """The boundary conditions at ``t``; the rollback also resets the
        heat field."""
        eq, heat = self.eq_mom, self.eq_heat
        eq.bc.update_dirichlet(t)
        eq.bc.update_neumann(t)
        restore_mech = super()._begin_step(t)
        T, T_old = heat.T, heat.T_old

        def restore():
            restore_mech()
            heat.T, heat.T_old = T, T_old
        return restore

    def _attempt(self, t, dt):
        """The heat step, the elements' temperature, then the momentum
        step."""
        self.eq_heat.solve(t, dt)
        self.eq_mom.set_T(self.eq_heat.get_T_elems())
        return super()._attempt(t, dt)

    def _dump_diagnostics(self, t, dt):
        """None: when the retries run out the coupled driver restores the
        state and writes no dump."""
