"""Simulation drivers (port of ``safeincave_tpu/simulators.py``).

* ``Simulator_M``: theta-scheme time loop over a momentum equation with
  fixed-point iteration (tol 1e-8, <= 40 iterations), dt-halving retry
  (<= 3) with a full state snapshot and restore on divergence or NaN, a
  diagnostic dump after exhausted retries, and commit only if converged.
  Between output and checkpoint boundaries the steps run as fused chunks
  through ``LinearMomentum.solve_time_steps``; a step that fails inside a
  chunk rewinds to the per-step retry flow.
* ``Simulator_Mout``: the same loop without dt-retry.
* ``Simulator_T``: the heat-only loop, fused between output boundaries
  through ``HeatDiffusion.solve_steps``.
* ``Simulator_TM``: heat step, then the momentum fixed point (tol 1e-6,
  <= 20 iterations) with one-way temperature coupling, fused through
  ``LinearMomentum.solve_tm_time_steps``; the dt-halving retry restores the
  heat field together with the mechanical state.
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

    # ------------------------------------------------------------------ #
    def _plan_chunk_size(self) -> int:
        """Steps to advance in one fused ``solve_time_steps`` call.

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
            cap = 64
            # an adaptive controller changes dt only at chunk boundaries
            if hasattr(self.t_control, "feedback"):
                cap = 4
        if not cap or cap <= 1:
            return 1
        eq = self.eq_mom
        if not hasattr(eq, "solve_time_steps"):
            return 1
        if type(eq).run_after_solve is not LinearMomentumBase.run_after_solve:
            return 1
        if ("solve_time_step" in eq.__dict__
                or "solve_time_steps" in eq.__dict__):
            return 1
        cap = _output_cap(self.outputs, cap)
        if self.checkpoint_every:
            s0 = self.t_control.step_counter
            cap = min(cap, self.checkpoint_every
                      - s0 % self.checkpoint_every)
        return max(int(cap), 1)

    def _run_fused_chunk(self, chunk: int) -> bool:
        """Advance up to ``chunk`` steps through one ``solve_time_steps``.

        Returns True when every planned step converged (outputs, metrics,
        screen rows and checkpoints accounted for).  Returns False when a
        step failed: the equation then holds that step's entry state and
        the time controller is rewound, so the per-step dt-retry flow
        re-attempts exactly that step."""
        eq, tc = self.eq_mom, self.t_control
        s0, t0 = tc.step_counter, tc.t
        ts, dts = _planned_steps(tc, chunk)
        if not ts:
            return True
        tracing.at_step(s0 + 1)
        tracing.take_walls()
        t_wall0 = tracing.now()
        stats = eq.solve_time_steps(ts, dts, tol=self.tol,
                                    maxiter=self.maxiter)
        chunk_wall = 1e-9 * (tracing.now() - t_wall0)
        walls = tracing.take_walls()
        conv = (stats[:, 5] > 0.5).astype(int)
        n_ok = int(conv.cumprod().sum())     # converged prefix length
        self._converged += n_ok
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
                int(stats[k, 0]), float(stats[k, 1]),
            ])
        if n_ok and hasattr(tc, "feedback"):
            # adapt the next chunk's dt from this chunk's mean fixed-point
            # work; a partial failure reports one cut, so the controller
            # shrinks before the retry re-attempts the failed step
            tc.feedback(float(stats[:n_ok, 0].mean()),
                        dt_cuts=0 if n_ok == len(ts) else 1)
        if n_ok == len(ts):
            for output in self.outputs:
                output.skip_calls(n_ok - 1)
            self._save_derived_and_outputs(ts[-1])
            if (self.checkpoint_every
                    and tc.step_counter % self.checkpoint_every == 0):
                save_checkpoint(self.checkpoint_path, eq, tc)
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
        tracing.open_run(getattr(eq, "counters", None),
                         cuda=eq.device.type == "cuda")
        completed = False
        try:
            self._run()
            completed = True
        finally:
            tracing.close_run(self._converged, completed)

    def _run(self):
        eq = self.eq_mom
        tc = self.t_control
        # tc.step_counter > 0: load_checkpoint restored a mid-run state,
        # committed rates included; initializing the rates again would
        # overwrite them and break exact continuation
        resumed = tc.step_counter > 0

        for output in self.outputs:
            output.initialize()

        eq.bc.update_dirichlet(tc.t)
        eq.bc.update_neumann(tc.t)

        if self.compute_elastic_response and not resumed:
            eq.solve_elastic_response()
            eps_tot = eq.compute_total_strain()
            stress = eq.compute_elastic_stress(eps_tot)
        else:
            eps_tot = eq.compute_total_strain()
            stress = eq.sig_v

        if not resumed:
            eq.compute_eps_ne_rate(stress, tc.t)
            eq.update_eps_ne_rate_old()
            self._save_derived_and_outputs(0.0)

        while tc.keep_looping():
            chunk = self._plan_chunk_size()
            fused_failed = False
            if chunk > 1:
                all_converged = self._run_fused_chunk(chunk)
                # on failure eq holds the failed step's entry state: refresh
                # the locals so the retry backs up the right state
                stress = eq.sig_v
                eps_tot = eq.eps_tot_v
                if all_converged:
                    continue
                fused_failed = True
            # a chunk of 1, or a fused step that failed (tc rewound to it):
            # the per-step flow with dt-halving retry
            tc.advance_time()
            t, dt = tc.t, tc.dt
            tracing.at_step(tc.step_counter)

            stress_backup = stress
            eps_backup = eps_tot
            u_backup = eq.u
            eq.save_internal_state()

            def restore_step_state():
                """Full rollback to the pre-attempt state: solve_time_step
                reads eq.sig_v, eq.eps_tot_v and eq.u (the Krylov initial
                guess), so a retry resets them as well as every element's
                state."""
                eq.sig_v = stress_backup
                eq.eps_tot_v = eps_backup
                eq.u = u_backup
                eq._last_sv_k = stress_backup
                eq.restore_internal_state()

            dt_current = dt
            dt_cut = 0
            step_converged = False
            ite, error = 0, 2 * self.tol
            stress_k = stress

            while not step_converged and dt_cut <= self.max_dt_cuts:
                # retries run pure f64 (no f32 sweep), so that a failure the
                # mixed-precision path caused is not repeated; so does the
                # first host attempt after a fused failure, which already
                # ran the f32 path from this exact state
                eq._fp32_disable = dt_cut > 0 or fused_failed
                ite, error = eq.solve_time_step(t, dt_current, tol=self.tol,
                                                maxiter=self.maxiter)
                stress = eq.sig_v
                eps_tot = eq.eps_tot_v
                stress_k = eq._last_sv_k

                if not np.isnan(error) and error <= self.tol:
                    step_converged = True
                else:
                    dt_cut += 1
                    if dt_cut <= self.max_dt_cuts:
                        print(f"[SOLVER] Step {tc.step_counter}: "
                              f"{'NaN' if np.isnan(error) else 'no convergence'} "
                              f"after {ite} iters - halving dt, "
                              f"retry {dt_cut}/{self.max_dt_cuts}",
                              file=sys.stderr)
                        dt_current = dt_current / 2
                        restore_step_state()
                        stress = stress_backup
                        eps_tot = eps_backup
                    else:
                        self._dump_diagnostics(t, dt_current)
                        restore_step_state()
                        stress = stress_backup
                        eps_tot = eps_backup
                        stress_k = stress_backup

            # give later direct solve_time_step calls and the next fused
            # chunk the f32 sweep back
            eq._fp32_disable = False

            if step_converged:
                self._converged += 1
                eq.commit_time_step(dt_current, stress, stress_k)
                if hasattr(tc, "feedback"):
                    tc.feedback(ite, dt_cuts=dt_cut)

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


class Simulator_TM(Simulator):
    """One-way coupled thermo-mechanics."""

    tol = 1e-6
    maxiter = 20
    max_dt_cuts = 3

    def __init__(self, eq_mom, eq_heat, t_control, outputs,
                 compute_elastic_response: bool = True,
                 fused_steps: int | str = "auto"):
        self.eq_mom = eq_mom
        self.eq_heat = eq_heat
        self.t_control = t_control
        self.outputs = outputs
        self.compute_elastic_response = compute_elastic_response
        self.fused_steps = fused_steps
        ScreenPrinter.reset_instance()
        self.screen = ScreenPrinter(eq_mom.grid, eq_mom.solver, eq_mom.mat,
                                    outputs, t_control.time_unit)

    # ------------------------------------------------------------------ #
    def _plan_chunk_size(self) -> int:
        """Steps per fused ``solve_tm_time_steps`` call (see
        ``Simulator_M._plan_chunk_size``): a chunk commits only its
        converged prefix, and a failed step rewinds to the per-step
        dt-retry flow."""
        cap = self.fused_steps
        if cap == "auto":
            cap = 64
        if not cap or cap <= 1:
            return 1
        eq, heat = self.eq_mom, self.eq_heat
        if not hasattr(eq, "solve_tm_time_steps"):
            return 1
        if type(eq).run_after_solve is not LinearMomentumBase.run_after_solve:
            return 1
        if ("solve_time_step" in eq.__dict__
                or "solve_tm_time_steps" in eq.__dict__
                or "solve" in heat.__dict__):
            return 1
        return _output_cap(self.outputs, cap)

    def _run_fused_chunk(self, chunk: int) -> bool:
        """Advance up to ``chunk`` fused TM steps.  Returns True when every
        planned step converged; on a failed step the equation and the heat
        field hold that step's entry state, the controller is rewound to
        it, and the per-step dt-retry flow re-attempts it."""
        eq, heat, tc = self.eq_mom, self.eq_heat, self.t_control
        s0, t0 = tc.step_counter, tc.t
        ts, dts = _planned_steps(tc, chunk)
        if not ts:
            return True
        tracing.at_step(s0 + 1)
        stats = eq.solve_tm_time_steps(heat, ts, dts, tol=self.tol,
                                       maxiter=self.maxiter)
        conv = (stats[:, 5] > 0.5).astype(int)
        n_ok = int(conv.cumprod().sum())
        self._converged += n_ok
        for k in range(n_ok):
            current_time = "%.3f" % (ts[k] / tc.time_conversion)
            self.screen.print_row([
                s0 + 1 + k, dts[k] / tc.time_conversion,
                f"{current_time} / {tc.t_final / tc.time_conversion}",
                int(stats[k, 2]), float(stats[k, 3]),
            ])
        if n_ok == len(ts):
            for output in self.outputs:
                output.skip_calls(n_ok - 1)
            self._save_derived_and_outputs(ts[-1])
            return True
        for output in self.outputs:
            output.skip_calls(n_ok)
        tc.step_counter = s0 + n_ok
        tc.t = ts[n_ok - 1] if n_ok else t0
        return False

    run = Simulator_M.run

    def _run(self):
        eq = self.eq_mom
        heat = self.eq_heat
        tc = self.t_control

        for output in self.outputs:
            output.initialize()

        eq.set_T0(heat.get_T_elems())

        eq.bc.update_dirichlet(tc.t)
        eq.bc.update_neumann(tc.t)

        if self.compute_elastic_response:
            eq.solve_elastic_response()
            eps_tot = eq.compute_total_strain()
            stress = eq.compute_elastic_stress(eps_tot)
        else:
            eq.compute_total_strain()
            stress = eq.sig_v

        T_elems = heat.get_T_elems()
        eq.set_T(T_elems)
        eq.set_T0(T_elems)

        eq.compute_eps_ne_rate(stress, tc.t)
        eq.update_eps_ne_rate_old()

        self._save_derived_and_outputs(0.0)

        while tc.keep_looping():
            chunk = self._plan_chunk_size()
            fused_failed = False
            if chunk > 1:
                if self._run_fused_chunk(chunk):
                    continue
                fused_failed = True
            tc.advance_time()
            t, dt = tc.t, tc.dt
            tracing.at_step(tc.step_counter)

            eq.bc.update_dirichlet(t)
            eq.bc.update_neumann(t)

            # dt-halving retry around the coupled step: the hardening
            # linearization can overshoot under a large thermal-stress
            # increment, and the cure is a smaller dt, as in Simulator_M.
            # The backups share the live tensors: a step replaces them and
            # never writes into them.
            stress_backup, eps_backup, u_backup = eq.sig_v, eq.eps_tot_v, eq.u
            T_backup, T_old_backup = heat.T, heat.T_old
            eq.save_internal_state()

            def restore():
                eq.sig_v, eq.eps_tot_v, eq.u = (stress_backup, eps_backup,
                                                u_backup)
                eq._last_sv_k = stress_backup
                eq.restore_internal_state()
                heat.T, heat.T_old = T_backup, T_old_backup

            dt_current = dt
            dt_cut = 0
            step_converged = False
            ite, error = 0, 2 * self.tol
            while not step_converged and dt_cut <= self.max_dt_cuts:
                eq._fp32_disable = dt_cut > 0 or fused_failed
                heat.solve(t, dt_current)
                eq.set_T(heat.get_T_elems())
                ite, error = eq.solve_time_step(t, dt_current, tol=self.tol,
                                                maxiter=self.maxiter)
                if not np.isnan(error) and error <= self.tol:
                    step_converged = True
                else:
                    dt_cut += 1
                    restore()
                    if dt_cut <= self.max_dt_cuts:
                        print(f"[SOLVER] TM step {tc.step_counter}: "
                              f"{'NaN' if np.isnan(error) else 'no convergence'}"
                              f" after {ite} iters - halving dt, "
                              f"retry {dt_cut}/{self.max_dt_cuts}",
                              file=sys.stderr)
                        dt_current = dt_current / 2
            eq._fp32_disable = False

            if step_converged:
                self._converged += 1
                eq.commit_time_step(dt_current, eq.sig_v, eq._last_sv_k)

            self._save_derived_and_outputs(t)
            current_time = "%.3f" % (t / tc.time_conversion)
            self.screen.print_row([
                tc.step_counter, tc.dt / tc.time_conversion,
                f"{current_time} / {tc.t_final / tc.time_conversion}",
                ite, error,
            ])

        self.screen.close()
        for output in self.outputs:
            output.save_mesh()

    _save_derived_and_outputs = Simulator_M._save_derived_and_outputs
