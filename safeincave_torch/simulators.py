"""Simulation drivers (port of the mechanics drivers of
``safeincave_tpu/simulators.py``).

* ``Simulator_M``: theta-scheme time loop over a momentum equation with
  fixed-point iteration (tol 1e-8, <= 40 iterations), dt-halving retry
  (<= 3) with a full state snapshot and restore on divergence or NaN, a
  diagnostic dump after exhausted retries, and commit only if converged.
  Between output and checkpoint boundaries the steps run as fused chunks
  through ``LinearMomentum.solve_time_steps``; a step that fails inside a
  chunk rewinds to the per-step retry flow.
* ``Simulator_Mout``: the same loop without dt-retry.

The thermal and thermo-mechanical drivers wait for the heat equation's port.
"""
from __future__ import annotations

import os
import sys
import time
from abc import ABC, abstractmethod

import numpy as np

from .checkpoint import save_checkpoint
from .fem.momentum import LinearMomentumBase
from .metrics import StepMetrics
from .output.screen import ScreenPrinter
from .utils import to_numpy, voigt_to_tensor


class Simulator(ABC):
    @abstractmethod
    def run(self):
        ...


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
        for output in self.outputs:
            fn = getattr(output, "calls_until_next_keep", None)
            if fn is None:
                return 1
            cap = min(cap, fn())
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
        ts, dts = [], []
        while tc.keep_looping() and len(ts) < chunk:
            tc.advance_time()
            ts.append(tc.t)
            dts.append(tc.dt)
        if not ts:
            return True
        t_wall0 = time.time()
        stats = eq.solve_time_steps(ts, dts, tol=self.tol,
                                    maxiter=self.maxiter)
        chunk_wall = time.time() - t_wall0
        conv = (stats[:, 5] > 0.5).astype(int)
        n_ok = int(conv.cumprod().sum())     # converged prefix length
        for k in range(n_ok):
            step_no = s0 + 1 + k
            if self.metrics is not None:
                # each step's share of the chunk's wall-clock, flagged fused
                self.metrics.record(step_no, ts[k], dts[k],
                                    int(stats[k, 0]), float(stats[k, 1]),
                                    wall_s=chunk_wall / max(n_ok, 1),
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
        eq = self.eq_mom
        eq.compute_p_elems()
        eq.compute_q_elems()
        eq.compute_p_nodes()
        eq.compute_q_nodes()
        for output in self.outputs:
            output.save_fields(t)

    def _dump_diagnostics(self, t, dt):
        """NaN diagnostic dump to ``nan_diagnostic.npz`` in the working
        directory, with the JAX package's keys."""
        eq = self.eq_mom
        diag = {
            "step": self.t_control.step_counter,
            "t": t,
            "dt": dt,
            "stress": to_numpy(voigt_to_tensor(eq.sig_v)),
            "eps_tot": to_numpy(voigt_to_tensor(eq.eps_tot_v)),
            "C_inv": to_numpy(eq.mat.C_inv),
        }
        if hasattr(eq.mat, "G"):
            diag["G_total"] = to_numpy(eq.mat.G)
        for idx, e in enumerate(eq.mat.elems_ne):
            prefix = f"elem_{idx}_{e.name}"
            diag[f"{prefix}_eps_ne_rate"] = to_numpy(e.state["rate"])
            diag[f"{prefix}_G"] = to_numpy(e.state["G"])
            diag[f"{prefix}_B"] = to_numpy(e.state["B"])
            for key in ("alpha", "qsi", "Fvp", "r", "h", "zeta"):
                if key in e.state:
                    diag[f"{prefix}_{key}"] = to_numpy(e.state[key])
        path = os.path.join(os.getcwd(), "nan_diagnostic.npz")
        np.savez(path, **diag)
        print(f"[SOLVER] All {self.max_dt_cuts} retries failed at step "
              f"{self.t_control.step_counter}. Diagnostic saved to {path}",
              file=sys.stderr)


class Simulator_Mout(Simulator_M):
    """Mechanics driver without dt-retry."""
    max_dt_cuts = 0
