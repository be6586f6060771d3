"""Production-study idioms: interlayered cavern, MunsonDawson salt + frictional
interlayers, CSV/sinus pressure schedules, sparse output, solver logging.

The port's twin of examples/mechanics/nobian_interlayer/main.py, with the
same extension patterns on the port's classes:

* per-region constitutive assignment: MunsonDawson creep in the salt,
  Mohr-Coulomb viscoplasticity in an interlayer band;
* pressure schedules from safeincave_torch.schedules - a CSV operational
  profile when one is given, otherwise a sinus cycle;
* SparseSaveFields - write every Nth step only (a ``SaveFields``
  subclass overriding ``save_fields``);
* SimulatorWithSolverLog - per-step Krylov iteration/residual JSONL (a
  ``Simulator_M`` subclass wrapping its outputs' ``save_fields``);
* run_after_solve hook exporting the viscoplastic yield state.
"""
import json
import os

import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

import safeincave_torch as sc  # noqa: E402
import safeincave_torch.schedules as schedules  # noqa: E402
from safeincave_torch.utils import GPa, MPa  # noqa: E402

momBC = sc.MomentumBC


class SparseSaveFields(sc.SaveFields):
    """Write only every `interval`-th step (t=0 always)."""

    def __init__(self, eq, interval: int):
        super().__init__(eq)
        self.interval = max(1, int(interval))
        self._counter = 0

    def save_fields(self, t):
        if t == 0:
            return super().save_fields(t)
        self._counter += 1
        if self._counter % self.interval == 0:
            return super().save_fields(t)


class SolverLogger:
    """Per-step linear-solver stats to JSONL (KSPConvergenceLogger analog)."""

    def __init__(self, eq, filepath: str):
        self.eq = eq
        os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
        self._fh = open(filepath, "w", buffering=1)

    def record(self, t: float):
        its, rnorm = self.eq.solver_stats
        rec = {"t": float(t), "krylov_its": int(its),
               "krylov_rnorm": float(rnorm),
               "krylov_total": int(self.eq.krylov_total)}
        self._fh.write(json.dumps(rec) + "\n")

    def close(self):
        self._fh.close()


class SimulatorWithSolverLog(sc.Simulator_M):
    """Wrap outputs so each save also logs solver stats."""

    def __init__(self, eq, tc, outputs, compute_elastic_response,
                 logger: SolverLogger):
        super().__init__(eq, tc, outputs,
                         compute_elastic_response=compute_elastic_response)
        self._logger = logger

    def run(self):
        for out in self.outputs:
            orig = out.save_fields

            def wrapped(t, _orig=orig):
                self._logger.record(t)
                return _orig(t)

            out.save_fields = wrapped
        return super().run()


class LinearMomentumVP(sc.LinearMomentum):
    """run_after_solve hook exporting the last element's yield state."""

    def run_after_solve(self):
        elems = self.mat.elems_ne
        if elems and "Fvp" in elems[-1].state:
            self.Fvp = elems[-1].state["Fvp"]


def main(operation_days=2.0, dt_hours=2.0, csv_path=None,
         interlayer_z=(0.4, 0.6), output_root="output",
         timestepping="fixed", device=None):
    """``timestepping``: 'fixed' (reference default), 'adaptive'
    (AdaptiveTimeController - grows dt on fast convergence, shrinks on
    retries) or 'dp-limit' (a prescribed variable grid refined through
    pressure ramps, the reference VariableTimestep.py:354-384 workflow)."""
    # box proxy standing in for the interlayer cavern meshes (the nobian
    # grids' physics: salt body with a horizontal interlayer band)
    grid = sc.GridBox(Lx=1.0, Ly=1.0, Lz=1.0, nx=5, ny=5, nz=5)
    n = grid.n_elems
    one = np.ones(n)

    z_cent = grid.centroids[:, 2]
    in_layer = (z_cent >= interlayer_z[0]) & (z_cent < interlayer_z[1])
    ind_salt = np.where(~in_layer)[0]
    ind_il = np.where(in_layer)[0]

    eq = LinearMomentumVP(grid, theta=0.5, device=device)
    eq.set_solver(sc.SolverSettings(method="bicgstab", rtol=1e-12,
                                    max_it=400))

    mat = sc.Material(n, device=device)
    mat.set_density(2200.0 * one)

    E0 = np.full(n, 102 * GPa)
    E0[ind_il] = 45 * GPa
    mat.add_to_elastic(sc.Spring(E0, 0.3 * one, "spring"))

    # MunsonDawson transient creep in the salt only (zero prefactor in the
    # interlayer disables it there, the reference's per-region idiom)
    # scenario-A MunsonDawson calibration (run_interlayer.py:1207-1211);
    # zero prefactor on interlayer cells disables MD creep there
    sec_per_year = 365.25 * 24 * 3600
    nmd = 4.99
    A_val = 18.31 * (1e-6) ** nmd / sec_per_year
    A_md = np.full(n, A_val)
    A_md[ind_il] = 0.0
    mu_md = E0 / (2.0 * (1.0 + 0.3))
    mat.add_to_non_elastic(sc.MunsonDawsonCreep(
        A=A_md, Q=6356.0 * 8.32 * one, n=nmd * one,
        K0=7.0e-7 * one, c=9.02e-3 * one, m=3.0 * one,
        alpha_w=-13.2 * one, beta_w=-7.738 * one, delta=0.58 * one,
        mu=mu_md, name="munson_dawson", device=device))

    # Mohr-Coulomb viscoplastic interlayer (zero fluidity in the salt)
    mu_mc = np.zeros(n)
    mu_mc[ind_il] = 1e-10
    mat.add_to_non_elastic(sc.MohrCoulombViscoplastic(
        mu_1=mu_mc, N_1=1.0 * one,
        cohesion=1.0 * MPa * one, friction_angle=np.deg2rad(30.0) * one,
        dilation_angle=np.deg2rad(10.0) * one, sigma_t=1.5 * MPa * one,
        name="mc_interlayer", device=device))

    eq.set_material(mat)
    eq.set_T0(298.0 * one)
    eq.set_T(298.0 * one)
    eq.build_body_force([0.0, 0.0, 0.0])

    if timestepping == "adaptive":
        tc = sc.AdaptiveTimeController(dt=dt_hours, initial_time=0.0,
                                       final_time=operation_days * 24.0,
                                       time_unit="hour",
                                       dt_min=dt_hours / 8,
                                       dt_max=4 * dt_hours)
    else:
        tc = sc.TimeController(dt=dt_hours, initial_time=0.0,
                               final_time=operation_days * 24.0,
                               time_unit="hour")

    # pressure schedule: CSV operational profile if given, else sinus cycle
    p_base = 12 * MPa
    if csv_path:
        t_vals, p_vals = schedules.build_csv_pressure_schedule(
            tc, csv_path, days=operation_days, mode="stretch",
            total_cycles=1, rescale=True,
            rescale_min=6.0, rescale_max=14.0)
    else:
        t_vals, p_vals = schedules.build_sinus_pressure_schedule(
            tc, p_mean=p_base, p_ampl=4 * MPa, period_hours=24.0,
            clamp_min=4 * MPa)
    schedules.apply_startup_ramp(t_vals, p_vals, p_start_pa=p_vals[0],
                                 ramp_hours=0.0, dt_hours=dt_hours)
    if timestepping == "dp-limit":
        # variable grid: fine steps through pressure ramps, coarse through
        # plateaus (|dp| <= 0.5 MPa per step)
        p_of_t = lambda t: float(np.interp(t, t_vals, p_vals))  # noqa: E731
        grid_t = sc.build_time_list_by_dp_limit(
            tc.t_final, p_of_t, dt_min=dt_hours * 900.0,
            dt_max=dt_hours * 3600.0 * 4, dp_max=0.5e6)
        tc = sc.TimeControllerFromList(grid_t, time_unit="hour")

    bc = momBC.BcHandler(eq)
    tv = [0.0, tc.t_final]
    bc.add_boundary_condition(momBC.DirichletBC("WEST", 0, [0., 0.], tv))
    bc.add_boundary_condition(momBC.DirichletBC("SOUTH", 1, [0., 0.], tv))
    bc.add_boundary_condition(momBC.DirichletBC("BOTTOM", 2, [0., 0.], tv))
    for name in ("EAST", "NORTH"):
        bc.add_boundary_condition(momBC.NeumannBC(
            name, 2, 0.0, 0.0, [8 * MPa, 8 * MPa], tv, g=0.0))
    bc.add_boundary_condition(momBC.NeumannBC(
        "TOP", 2, 0.0, 0.0, p_vals, t_vals, g=0.0))
    eq.set_boundary_conditions(bc)

    out = SparseSaveFields(eq, interval=4)
    out.set_output_folder(os.path.join(output_root, "nobian_interlayer"))
    out.add_output_field("u", "Displacement (m)")
    out.add_output_field("q_elems", "Von Mises (Pa)")

    logger = SolverLogger(eq, os.path.join(output_root, "nobian_interlayer",
                                           "ksp_log.jsonl"))
    sim = SimulatorWithSolverLog(eq, tc, [out], True, logger)
    sim.run()
    logger.close()
    return eq


if __name__ == "__main__":
    main()
