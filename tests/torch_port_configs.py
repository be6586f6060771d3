"""Problem set-up shared by the PyTorch-port parity tests, the port's
golden generator and chip_smoke.py.

Each function takes the package module (``safeincave_tpu`` or
``safeincave_torch``), whose public APIs match, so both packages are set up
from identical inputs.  ``device`` places the port's objects (its entry
points run on the card unless given ``device="cpu"``, as the tests do); the
JAX package takes no such argument.  The material and loads are the cavern
benchmark's (bench.py:build): Spring + Viscoelastic + DislocationCreep +
ViscoplasticDesai, roller supports on the three lower faces and a 24 h
sinusoidal pressure on the loaded faces.  The thermo-mechanical set-ups
(``wire_tm``) take bench.py's second configuration (bench_tm).  The yearly
production run (``yearly_*``) is examples/mechanics/nobian_yearly/main.py
``--full``; the calibration twins (``creep_model``, ``triaxial_twin``) are
those of examples/mechanics/MaterialCalibration.
"""
import os

import numpy as np

MPa = 1e6
HOUR = 3600.0
SETTINGS = dict(method="bicgstab", rtol=1e-12, max_it=400, coarse_agg=8)
FIXED = [("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2),
         ("West", 0), ("South", 1), ("Bottom", 2)]
LOADED = ["EAST", "NORTH", "TOP", "East", "North", "Top",
          "Cavern", "CAVERN", "Wall", "WALL"]


def on(pkg, device):
    """``device`` as keyword arguments of the port's constructors; none for
    the JAX package."""
    if device is None or pkg.__name__ != "safeincave_torch":
        return {}
    return {"device": device}


def bench_material(pkg, n, device=None):
    one = np.ones(n)
    dev = on(pkg, device)
    mat = pkg.Material(n, **dev)
    mat.set_density(2200.0 * one)
    mat.add_to_elastic(pkg.Spring(102e9 * one, 0.3 * one))
    mat.add_to_non_elastic(pkg.Viscoelastic(105e11 * one, 10e9 * one,
                                            0.32 * one, **dev))
    mat.add_to_non_elastic(pkg.DislocationCreep(1.9e-20 * one, 51600 * one,
                                                3.0 * one, **dev))
    mat.add_to_non_elastic(pkg.ViscoplasticDesai(
        mu_1=5.3665857009859815e-11 * one, N_1=3.1 * one,
        a_1=1.965018496922832e-05 * one, eta=0.8275682807874163 * one,
        n=3.0 * one, beta_1=0.0048 * one, beta=0.995 * one, m=-0.5 * one,
        gamma=0.095 * one, sigma_t=5.0 * one, alpha_0=0.0022 * one, **dev))
    return mat


def wire_bench(pkg, grid, precond="2level", fp32_phase=False, device=None,
               **eq_kw):
    """The cavern benchmark's equation on ``grid`` (fp32 phase off unless
    asked for)."""
    eq = pkg.LinearMomentum(grid, theta=0.5, **on(pkg, device), **eq_kw)
    eq.set_solver(pkg.SolverSettings(precond=precond, fp32_phase=fp32_phase,
                                     **SETTINGS))
    n = eq.n_elems
    eq.set_material(bench_material(pkg, n, device))
    eq.set_T0(298.0 * np.ones(n))
    eq.set_T(298.0 * np.ones(n))
    eq.build_body_force([0.0, 0.0, 0.0])
    bench_bcs(pkg, eq)
    return eq


def bench_bcs(pkg, eq):
    """The cavern benchmark's supports and 24 h sinusoidal pressure on
    ``eq``'s grid."""
    momBC = pkg.MomentumBC
    names = eq.grid.get_boundary_names()
    bc = momBC.BcHandler(eq)
    tv = [0.0, 1e12]
    for nm, comp in FIXED:
        if nm in names:
            bc.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.],
                                                        tv))
    t_sched = np.arange(0.0, 400 * HOUR, HOUR)
    p_sched = 10 * MPa + 4 * MPa * np.sin(2 * np.pi * t_sched / (24 * HOUR))
    for nm in LOADED:
        if nm in names:
            bc.add_boundary_condition(momBC.NeumannBC(
                nm, 2, 0.0, 0.0, list(p_sched), list(t_sched), g=0.0))
    eq.set_boundary_conditions(bc)


def cavern600_grid(pkg):
    path = pkg.Utils.find_grid("cavern_regular_600_3D",
                               fallback="cavern_proxy_600")
    return pkg.GridHandlerGMSH("geom", path, reorder="band")


def box17_grid(pkg):
    """bench.py's box configuration (its fallback when no cavern mesh is
    found), in natural order: 5,832 nodes, 29,478 tets."""
    return pkg.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=17, ny=17, nz=17)


def wire_flagged(pkg, grid, flags, precond="2level", device=None, **eq_kw):
    """:func:`wire_bench` with solver options (``lag_tangent``,
    ``adaptive_rtol``, ``precond_bf16``) beside the pinned settings, the
    f32 sweep off."""
    eq = wire_bench(pkg, grid, precond=precond, device=device, **eq_kw)
    eq.set_solver(pkg.SolverSettings(precond=precond, fp32_phase=False,
                                     **SETTINGS, **flags))
    return eq


def tm_material(pkg, n, device=None):
    """bench.py's thermo-mechanical material (bench_tm): Spring +
    Kelvin-Voigt + dislocation creep + pressure-solution creep +
    Thermoelastic, cp 850 J/kg/K, k 7 W/m/K."""
    one = np.ones(n)
    dev = on(pkg, device)
    mat = pkg.Material(n, **dev)
    mat.set_density(2200.0 * one)
    mat.add_to_elastic(pkg.Spring(102e9 * one, 0.3 * one))
    mat.add_to_non_elastic(pkg.Viscoelastic(105e11 * one, 10e9 * one,
                                            0.32 * one, **dev))
    mat.add_to_non_elastic(pkg.DislocationCreep(
        1.9e-20 * one, 51600 * one, 3.0 * one, name="ds_creep", **dev))
    mat.add_to_non_elastic(pkg.PressureSolutionCreep(
        1e-22 * one, 1e-2 * one, 51600 * one, name="ps_creep", **dev))
    mat.add_to_thermoelastic(pkg.Thermoelastic(44e-6 * one, **dev))
    mat.set_specific_heat_capacity(850.0 * one)
    mat.set_thermal_conductivity(7.0 * one)
    return mat


def wire_tm(pkg, grid, wall, precond="2level", fp32_phase=False,
            device=None, heat_precision="mixed", **eq_kw):
    """bench.py's thermo-mechanical configuration on ``grid``: the
    benchmark's mechanical loads, :func:`tm_material`, initial T 298 K, a
    Dirichlet ramp 298 -> 293 K over 12 h on TOP and a Robin wall (h = 5
    W/m2/K, 298 -> 283 K over 24 h) on the boundary ``wall``.  Returns
    (momentum equation, heat equation)."""
    dev = on(pkg, device)
    eq = pkg.LinearMomentum(grid, theta=0.5, **dev, **eq_kw)
    eq.set_solver(pkg.SolverSettings(precond=precond, fp32_phase=fp32_phase,
                                     **SETTINGS))
    mat = tm_material(pkg, eq.n_elems, device)
    eq.set_material(mat)
    eq.build_body_force([0.0, 0.0, 0.0])
    bench_bcs(pkg, eq)
    heat = pkg.HeatDiffusion(grid, **dev)
    heat.set_solver(pkg.SolverSettings(method="cg", rtol=1e-12, max_it=400,
                                       precision=heat_precision))
    heat.set_material(mat)
    heat.set_initial_T(298.0 * np.ones(grid.n_nodes))
    heatBC = pkg.HeatBC
    bc_h = heatBC.BcHandler(heat)
    bc_h.add_boundary_condition(heatBC.DirichletBC(
        "TOP", [298., 293., 293.], [0.0, 12 * HOUR, 1e12]))
    bc_h.add_boundary_condition(heatBC.RobinBC(
        wall, [298., 283., 283.], 5.0, [0.0, 24 * HOUR, 1e12]))
    heat.set_boundary_conditions(bc_h)
    return eq, heat


def tm_cube(pkg, device=None, extra=None, nx=3):
    """tests/golden_configs.py's ``build_tm_cube`` for either package: a
    cube with a heated TOP (330 K) and a Robin BOTTOM, Spring + Kelvin-Voigt
    + dislocation creep + Thermoelastic, 5 MPa on TOP.  ``extra(pkg, n,
    dev)`` returns one more inelastic element.  Returns (momentum, heat)."""
    dev = on(pkg, device)
    grid = pkg.GridBox(nx=nx, ny=nx, nz=nx)
    n = grid.n_elems
    one = np.ones(n)
    tv = [0.0, 1e9]
    heat = pkg.HeatDiffusion(grid, **dev)
    heat.set_solver(pkg.SolverSettings(method="cg", rtol=1e-12, max_it=500))
    mat = pkg.Material(n, **dev)
    mat.set_density(2200.0 * one)
    mat.add_to_elastic(pkg.Spring(102e9 * one, 0.3 * one))
    mat.add_to_non_elastic(pkg.Viscoelastic(105e11 * one, 10e9 * one,
                                            0.32 * one, **dev))
    mat.add_to_non_elastic(pkg.DislocationCreep(1.9e-20 * one, 51600 * one,
                                                3.0 * one, **dev))
    if extra is not None:
        mat.add_to_non_elastic(extra(pkg, n, dev))
    mat.set_specific_heat_capacity(850.0 * one)
    mat.set_thermal_conductivity(5.0 * one)
    mat.set_thermal_expansion(4.4e-5 * one)
    mat.add_to_thermoelastic(pkg.Thermoelastic(4.4e-5 * one, **dev))
    heat.set_material(mat)
    heat.set_initial_T(298.0 * np.ones(grid.n_nodes))
    heatBC = pkg.HeatBC
    bc_h = heatBC.BcHandler(heat)
    bc_h.add_boundary_condition(heatBC.DirichletBC("TOP", [330., 330.], tv))
    bc_h.add_boundary_condition(heatBC.RobinBC("BOTTOM", [298., 298.], 25.0,
                                               tv))
    heat.set_boundary_conditions(bc_h)

    eq = pkg.LinearMomentum(grid, theta=0.5, **dev)
    eq.set_solver(pkg.SolverSettings(method="bicgstab", rtol=1e-12,
                                     max_it=500))
    eq.set_material(mat)
    eq.build_body_force([0.0, 0.0, 0.0])
    momBC = pkg.MomentumBC
    bc_m = momBC.BcHandler(eq)
    for nm, comp in (("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2)):
        bc_m.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.],
                                                      tv))
    bc_m.add_boundary_condition(momBC.NeumannBC("TOP", 2, 0.0, 0.0,
                                                [5 * MPa, 5 * MPa], tv,
                                                g=0.0))
    eq.set_boundary_conditions(bc_m)
    return eq, heat


def tm_start(eq, heat):
    """The start of ``Simulator_TM.run`` (and of tests/golden_configs.py's
    ``run_tm``): T0 set around the elastic response, then the initial
    rates."""
    eq.set_T0(heat.get_T_elems())
    eq.bc.update_dirichlet(0.0)
    eq.bc.update_neumann(0.0)
    eq.solve_elastic_response()
    eps = eq.compute_total_strain()
    eq.compute_elastic_stress(eps)
    eq.set_T(heat.get_T_elems())
    eq.set_T0(heat.get_T_elems())
    eq.compute_eps_ne_rate(eq.sig_v, 0.0)
    eq.update_eps_ne_rate_old()


def run_tm_steps(eq, heat, n_steps=3, dt=HOUR):
    """tests/golden_configs.py's ``run_tm``: the per-step coupled loop with
    the reference-style commit calls; returns the rows (iterations,
    error)."""
    tm_start(eq, heat)
    rows = []
    for k in range(n_steps):
        t = (k + 1) * dt
        heat.solve(t, dt)
        eq.set_T(heat.get_T_elems())
        rows.append(eq.solve_time_step(t, dt, tol=1e-6, maxiter=20))
        eq.update_internal_variables()
        eq.update_eps_ne_rate_old()
        eq.update_eps_ne_old(eq.sig_v, eq._last_sv_k, dt)
    return np.asarray(rows, dtype=float)


def tm_init(eq, heat):
    """bench.py's initial state of the coupled run: T0 = T = the heat
    field on the elements, elastic response, initial creep rates."""
    T_el = heat.get_T_elems()
    eq.set_T0(T_el)
    eq.set_T(T_el)
    elastic_init(eq)


def run_tm_sim(pkg, eq, heat, outputs, hours=24.0, **sim_kw):
    """``pkg.Simulator_TM`` over ``hours`` at dt = 1 h; returns (time
    controller, rows of [fixed-point iterations, error] read from the
    driver's step table)."""
    tc = pkg.TimeController(dt=1.0, initial_time=0.0, final_time=hours,
                            time_unit="hour")
    sim = pkg.Simulator_TM(eq, heat, tc, outputs, **sim_kw)
    sim.run()
    return tc, screen_rows(sim.screen.lines)


def screen_rows(lines):
    """[iterations, error] of each step row of a driver's transcript."""
    rows = []
    for line in lines:
        cells = [c.strip() for c in line.split("|")]
        if len(cells) == 5 and cells[0].isdigit():
            rows.append([float(cells[3]), float(cells[4])])
    return np.asarray(rows, dtype=float).reshape(-1, 2)


def cavern_example(pkg, device=None, precond="2level", fp32_phase=False):
    """examples/mechanics/4_cavern/main.py's equation (Spring + creep,
    gravity, its solver) on the band-ordered cavern_proxy_600 mesh; the
    preconditioner and the fp32 phase are pinned as the goldens pin them
    unless asked otherwise."""
    grid = cavern600_grid(pkg)
    eq = pkg.LinearMomentum(grid, theta=0.5, **on(pkg, device))
    eq.set_solver(pkg.SolverSettings(method="bicgstab", rtol=1e-12,
                                     max_it=2000, precond=precond,
                                     fp32_phase=fp32_phase))
    n = grid.n_elems
    one = np.ones(n)
    dev = on(pkg, device)
    mat = pkg.Material(n, **dev)
    mat.set_density(2200.0 * one)
    mat.add_to_elastic(pkg.Spring(20.38e9 * one, 0.33 * one, "spring"))
    mat.add_to_non_elastic(pkg.DislocationCreep(1.9e-20 * one, 51600 * one,
                                                3.0 * one, "creep", **dev))
    eq.set_material(mat)
    eq.set_T0(298.0 * one)
    eq.set_T(298.0 * one)
    eq.build_body_force([0.0, 0.0, -9.81])
    return eq


# the two stages of 4_cavern/main.py: (hours, dt in hours, elastic response)
CAVERN_STAGES = {"equilibrium": (24.0, 2.0, True),
                 "operation": (48.0, 1.0, False)}
CAVERN_H = 430.0           # brine column reference elevation
CAVERN_RHO = 8.01942       # gas column density


def cavern_stage_bcs(pkg, eq, stage, t_final):
    """4_cavern/main.py's boundary conditions of ``stage``: rollers on the
    sides and the bottom, 10 MPa overburden on top, the cavern pressure (10
    MPa in equilibrium, a 6-12 MPa daily cycle in operation)."""
    momBC = pkg.MomentumBC
    if stage == "equilibrium":
        tv = [0.0, t_final]
        p_cavern = [10 * MPa, 10 * MPa]
    else:
        cycle_t = np.linspace(0.0, t_final, 49)
        tv = list(cycle_t)
        p_cavern = list(6 * MPa + 3 * MPa * (
            1 + np.sin(2 * np.pi * cycle_t / (24 * HOUR))))
    bc = momBC.BcHandler(eq)
    for nm, comp in (("WEST", 0), ("EAST", 0), ("SOUTH", 1), ("NORTH", 1),
                     ("BOTTOM", 2)):
        bc.add_boundary_condition(momBC.DirichletBC(nm, comp,
                                                    [0.0] * len(tv), tv))
    bc.add_boundary_condition(momBC.NeumannBC(
        "TOP", 2, 0.0, 0.0, [10 * MPa] * len(tv), tv, g=0.0))
    bc.add_boundary_condition(momBC.NeumannBC(
        "Cavern", 2, CAVERN_RHO, CAVERN_H, p_cavern, tv, g=-9.81))
    eq.set_boundary_conditions(bc)


def run_cavern_stage(pkg, eq, stage, outputs, **sim_kw):
    """One stage of the 4_cavern workflow through ``pkg.Simulator_M``;
    returns its time controller."""
    hours, dt, elastic = CAVERN_STAGES[stage]
    tc = pkg.TimeController(dt=dt, initial_time=0.0, final_time=hours,
                            time_unit="hour")
    cavern_stage_bcs(pkg, eq, stage, tc.t_final)
    pkg.Simulator_M(eq, tc, outputs, compute_elastic_response=elastic,
                    **sim_kw).run()
    return tc


def small_box(pkg, device=None, kelvin=False, top=10e6):
    """tests/test_output_config.py's ``_small_sim`` equation: a 2x2x2 box,
    Spring + DislocationCreep (+ Kelvin-Voigt, whose rate depends on t, when
    ``kelvin``), rollers on three faces and a constant load on TOP, CG."""
    grid = pkg.GridBox(nx=2, ny=2, nz=2)
    eq = pkg.LinearMomentum(grid, theta=0.5, **on(pkg, device))
    eq.set_solver(pkg.SolverSettings(method="cg", rtol=1e-12, max_it=300))
    n = eq.n_elems
    one = np.ones(n)
    dev = on(pkg, device)
    mat = pkg.Material(n, **dev)
    mat.set_density(2000.0 * one)
    mat.add_to_elastic(pkg.Spring(102e9 * one, 0.3 * one))
    if kelvin:
        mat.add_to_non_elastic(pkg.Viscoelastic(105e11 * one, 10e9 * one,
                                                0.32 * one, **dev))
    mat.add_to_non_elastic(pkg.DislocationCreep(1.9e-20 * one, 51600 * one,
                                                3.0 * one, **dev))
    eq.set_material(mat)
    eq.set_T0(298.0 * one)
    eq.set_T(298.0 * one)
    eq.build_body_force([0.0, 0.0, 0.0])
    momBC = pkg.MomentumBC
    bc = momBC.BcHandler(eq)
    tv = [0.0, 1e9]
    for nm, comp in (("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2)):
        bc.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.], tv))
    bc.add_boundary_condition(momBC.NeumannBC("TOP", 2, 0.0, 0.0,
                                              [top, top], tv, g=0.0))
    eq.set_boundary_conditions(bc)
    return eq


def as_np(x):
    """A field of either package (a torch tensor on any device, or a JAX
    array) as a numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


STAGE_FIELDS = ("u", "p_elems", "q_elems")


def stage_record(eq, metrics):
    """What a golden keeps of one simulator stage: the step table (rows of
    fixed-point iterations, error, converged) and the final fields."""
    rows = np.array([[r["fp_iters"], r["error"], float(r["converged"])]
                     for r in metrics.records], dtype=float).reshape(-1, 3)
    return {"rows": rows, **{f: as_np(getattr(eq, f)) for f in STAGE_FIELDS}}


def recording_simulator(pkg, records):
    """``pkg.Simulator_M`` with a StepMetrics recorder, appending each run's
    :func:`stage_record` to ``records``: patched over ``pkg.config``'s
    Simulator_M, it gives the JSON driver's stages their step tables."""
    class Recorded(pkg.Simulator_M):
        def __init__(self, *args, **kw):
            kw.setdefault("metrics", pkg.StepMetrics())
            super().__init__(*args, **kw)

        def run(self):
            super().run()
            records.append(stage_record(self.eq_mom, self.metrics))
    return Recorded


def box_case(grid_dir, out_dir, hour=HOUR):
    """tests/test_output_config.py's two-stage JSON case on the mesh
    ``grid_dir``/geom.msh: creep with gravity, rollers, a cyclic top load;
    equilibrium 2 x 1 h, operation 4 h at 1 h."""
    return {
        "output": {"path": str(out_dir)},
        "grid": {"path": str(grid_dir), "name": "geom"},
        "time_settings": {"theta": 0.5,
                          "time_list": [0.0, 2 * hour, 4 * hour]},
        "body_force": {"direction": 2, "gravity": -9.81, "density": 2200.0},
        "constitutive_model": {
            "elastic": {"spring": {"parameters": {"E": 102e9, "nu": 0.3}}},
            "nonelastic": {
                "creep": {"type": "DislocationCreep", "active": True,
                          "equilibrium": True,
                          "parameters": {"A": 1.9e-20, "Q": 51600,
                                         "n": 3.0, "T": 298.0}},
            },
        },
        "solver_settings": {"type": "KrylovSolver", "method": "cg",
                            "preconditioner": "jacobi",
                            "relative_tolerance": 1e-12},
        "simulation_settings": {
            "equilibrium": {"active": True, "dt_max": hour, "ite_max": 2},
            "operation": {"dt_max": hour, "hardening": False},
        },
        "boundary_conditions": {
            "WEST": {"type": "dirichlet", "component": 0,
                     "values": [0.0, 0.0, 0.0]},
            "SOUTH": {"type": "dirichlet", "component": 1,
                      "values": [0.0, 0.0, 0.0]},
            "BOTTOM": {"type": "dirichlet", "component": 2,
                       "values": [0.0, 0.0, 0.0]},
            "TOP": {"type": "neumann", "direction": 2, "density": 0.0,
                    "reference_position": 0.0,
                    "values": [8e6, 10e6, 8e6]},
        },
    }


# parameters of one JSON block of each element kind beyond the main path's
JSON_KINDS = {
    "PressureSolutionCreep": {"A": 1.29e-15, "d": 5e-3, "Q": 51600.0,
                              "T": 298.0},
    "MunsonDawsonCreep": {"A": 1.0e-22, "Q": 51600.0, "n": 3.0, "K0": 1e-6,
                          "c": 0.0092, "m": 3.0, "alpha_w": -10.0,
                          "beta_w": -0.7, "delta": 0.58, "mu": 12e9,
                          "T": 298.0},
    "MohrCoulombViscoplastic": {"mu_1": 1e-12, "N_1": 1.0, "cohesion": 1.0,
                                "friction_angle": np.radians(30.0),
                                "dilation_angle": np.radians(10.0),
                                "sigma_t": 5.0},
    "MatsuokaNakaiViscoplastic": {"mu_1": 1e-12, "N_1": 1.0, "cohesion": 1.0,
                                  "friction_angle": np.radians(30.0),
                                  "dilation_angle": np.radians(10.0),
                                  "sigma_t": 5.0},
}


def elastic_init(eq):
    """Elastic response + initial creep rates (the bench's init sequence)."""
    eq.bc.update_dirichlet(0.0)
    eq.bc.update_neumann(0.0)
    eq.solve_elastic_response()
    eps = eq.compute_total_strain()
    eq.compute_elastic_stress(eps)
    eq.compute_eps_ne_rate(eq.sig_v, 0.0)
    eq.update_eps_ne_rate_old()


# -- the yearly production run (examples/mechanics/nobian_yearly --full) ---- #
YEARLY_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "examples", "mechanics", "nobian_yearly", "data",
                          "operational_year.csv")
DAY = 24 * HOUR
# depth of the run: the mesh and the material are the example's, the
# equilibrium stage is its 30 days at 5 days, and of the 365-day operational
# year the first YEARLY_DAYS run at the example's documented 6 h step
YEARLY_DAYS = 4.0
YEARLY_DT_HOURS = 6.0
YEARLY_SAVE_EVERY = 8
YEARLY_CHECKPOINT_EVERY = 16


def yearly_grid(pkg):
    """The repo's 38k-tet production mesh (7,669 nodes), band-ordered."""
    return pkg.GridHandlerGMSH(
        "geom", pkg.Utils.find_grid("cavern_interlayer_1200"),
        reorder="band")


def yearly_build(pkg, device=None, precond="2level", fp32_phase=False):
    """nobian_yearly's ``build(full=True)``: the band-ordered 38k-tet
    cavern_interlayer_1200 mesh and the region-masked material (Spring,
    Kelvin-Voigt, dislocation creep in the salt, Mohr-Coulomb in the
    interlayers).  Returns (grid, equation)."""
    dev = on(pkg, device)
    grid = yearly_grid(pkg)
    regions = grid.get_subdomain_names()

    def per_region(salt_val, inter_val, over_val):
        return np.asarray(grid.get_parameter(
            {r: (inter_val if "nterlayer" in r
                 else over_val if "verburden" in r else salt_val)
             for r in regions}))

    n = grid.n_elems
    one = np.ones(n)
    inter = per_region(0.0, 1.0, 0.0)
    salt = per_region(1.0, 0.0, 0.0)
    eq = pkg.LinearMomentum(grid, theta=0.5, **dev)
    eq.set_solver(pkg.SolverSettings(method="bicgstab", rtol=1e-12,
                                     max_it=400, coarse_agg=8,
                                     precond=precond, fp32_phase=fp32_phase))
    GPa = 1e9
    mat = pkg.Material(n, **dev)
    mat.set_density(per_region(2200.0, 2900.0, 2500.0))
    mat.add_to_elastic(pkg.Spring(per_region(102, 70, 35) * GPa,
                                  per_region(0.30, 0.27, 0.25)))
    mat.add_to_non_elastic(pkg.Viscoelastic(
        per_region(105e11, 105e13, 105e13), 10 * GPa * one, 0.32 * one,
        **dev))
    mat.add_to_non_elastic(pkg.DislocationCreep(
        1.9e-20 * salt, 51600 * one, 3.0 * one, name="ds_creep", **dev))
    mat.add_to_non_elastic(pkg.MohrCoulombViscoplastic(
        mu_1=1e-9 * inter, N_1=1.0 * one, cohesion=4.0 * one,
        friction_angle=np.radians(35.0) * one, dilation_angle=0.0 * one,
        sigma_t=1.0 * one, name="mc_interlayer", **dev))
    eq.set_material(mat)
    eq.set_T0(298.0 * one)
    eq.set_T(298.0 * one)
    eq.build_body_force([0.0, 0.0, 0.0])
    return grid, eq


def yearly_bcs(pkg, eq, grid, t_vals, p_vals, p_top_pa=15 * MPa):
    """nobian_yearly's ``set_bcs``: roller sides, the overburden load on
    Top, the schedule on the cavern wall with the gas-column depth
    correction from the cavern's top."""
    momBC = pkg.MomentumBC
    names = grid.get_boundary_names()
    cav_tris = grid.tris[grid.get_boundary_tags("Cavern")]
    z_cav_top = float(grid.points[np.unique(cav_tris)][:, 2].max())
    bc = momBC.BcHandler(eq)
    tv = [0.0, max(t_vals[-1], 1.0)]
    for nm, comp in (("West", 0), ("East", 0), ("South", 1), ("North", 1),
                     ("Bottom", 2)):
        if nm in names:
            bc.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.],
                                                        tv))
    if "Top" in names:
        bc.add_boundary_condition(momBC.NeumannBC(
            "Top", 2, 0.0, 0.0, [p_top_pa, p_top_pa], tv, g=0.0))
    bc.add_boundary_condition(momBC.NeumannBC(
        "Cavern", 2, 8.02, z_cav_top, list(p_vals), list(t_vals), g=-9.81))
    eq.set_boundary_conditions(bc)


def run_yearly_stage(pkg, eq, grid, stage, outputs, **sim_kw):
    """One stage of the yearly run through ``pkg.Simulator_M``:
    "equilibrium" (30 days at 5 days, 10 MPa in the cavern, elastic
    response first) or "operation" (the first ``YEARLY_DAYS`` of the CSV
    year at ``YEARLY_DT_HOURS``, rescaled into the 7-12 MPa window, mode
    "direct").  Returns the stage's time controller."""
    if stage == "equilibrium":
        tc = pkg.TimeController(dt=5.0, initial_time=0.0, final_time=30.0,
                                time_unit="day")
        yearly_bcs(pkg, eq, grid, [0.0, tc.t_final], [10 * MPa, 10 * MPa])
    else:
        from importlib import import_module
        schedules = import_module(pkg.__name__ + ".schedules")
        tc = pkg.TimeController(dt=YEARLY_DT_HOURS, initial_time=0.0,
                                final_time=YEARLY_DAYS * 24.0,
                                time_unit="hour")
        t_vals, p_vals = schedules.build_csv_pressure_schedule(
            tc, YEARLY_CSV, days=YEARLY_DAYS, mode="direct", total_cycles=1,
            rescale=True, rescale_min=7.0, rescale_max=12.0)
        yearly_bcs(pkg, eq, grid, t_vals, p_vals)
    pkg.Simulator_M(eq, tc, outputs,
                    compute_elastic_response=stage == "equilibrium",
                    **sim_kw).run()
    return tc


YEARLY_FIELDS = {"equilibrium": ("u",), "operation": ("u", "q_elems")}


def yearly_record(eq, metrics, stage):
    """What the yearly golden keeps of a stage: the step table and the
    fields the stage saves, and sig_v."""
    rec = stage_record(eq, metrics)
    out = {"rows": rec["rows"], "sig_v": as_np(eq.sig_v)}
    for f in YEARLY_FIELDS[stage]:
        out[f] = as_np(getattr(eq, f))
    return out


# -- the calibration twins (examples/mechanics/MaterialCalibration) --------- #
CREEP_SIG = np.diag([-4e6, -4e6, -14e6])
CREEP_TIMES = np.linspace(0.0, 48 * 3600.0, 49)
CREEP_TRUE = {"A": 1.9e-20, "Q": 51600.0, "n": 3.0}
CREEP_FIT = dict(params0={"A": 5e-20, "n": 2.5}, lr=0.05, steps=300)


def creep_model(exp, asarray):
    """calibrate_creep.py's closed-form forward model (the axial
    dislocation-creep strain under constant stress) for an array library:
    ``exp`` its exponential, ``asarray`` its float64 constructor."""
    dev_zz = CREEP_SIG[2, 2] - np.trace(CREEP_SIG) / 3.0
    q = abs(CREEP_SIG[2, 2] - CREEP_SIG[0, 0])

    def axial_creep_strain(params):
        A_bar = (params["A"] * exp(-asarray(CREEP_TRUE["Q"]) / 8.32 / 298.0)
                 * q ** (params["n"] - 1.0))
        return A_bar * dev_zz * asarray(CREEP_TIMES)

    return axial_creep_strain


def creep_observed():
    """calibrate_creep.py's synthetic record: the true parameters' strain
    with 1 % seeded noise (numpy only)."""
    clean = creep_model(np.exp, np.asarray)(CREEP_TRUE)
    rng = np.random.default_rng(0)
    return clean * (1 + 0.01 * rng.standard_normal(clean.shape))


TRIAX_SR = np.array([-2.0 * MPa, -5.0 * MPa])
TRIAX_TRUE = {"cohesion": 3.0, "friction": np.radians(30.0)}


def triaxial_twin(pkg, cohesion, friction, times, ones, device=None):
    """calibrate_triaxial.py's ``run_twin``: the Mohr-Coulomb triaxial
    compression twin at two confinements, differentiable in (cohesion,
    friction); ``ones(n)`` makes the package's vector of ones.  Returns the
    ``run_compression`` result and the material."""
    n = len(TRIAX_SR)
    one = ones(n)
    dev = on(pkg, device)
    mat = pkg.Material(n, **dev)
    mat.add_to_elastic(pkg.Spring(25e9 * np.ones(n), 0.3 * np.ones(n)))
    mat.add_to_non_elastic(pkg.MohrCoulombViscoplastic(
        mu_1=2e-5 * one, N_1=1.5 * one, cohesion=cohesion * one,
        friction_angle=friction * one,
        dilation_angle=np.radians(10.0) * one, sigma_t=1.0 * one, **dev))
    sim = pkg.TriaxialSimulator(mat, theta=0.5)
    Ci = as_np(mat.C_inv)
    eps0 = (Ci[:, 2, 0] + Ci[:, 2, 1] + Ci[:, 2, 2]) * TRIAX_SR
    ez = eps0[None, :] - 1e-5 * np.asarray(times)[:, None]
    return sim.run_compression(TRIAX_SR, ez, times), mat


# -- the element-sharding cases (tests/test_sharding.py) -------------------- #
def sharding_box(pkg, nx=3, device=None, fp32_phase=False):
    """tests/test_sharding.py's ``_build`` equation for either package: a
    cube, Spring + dislocation creep, rollers on three faces, 10 MPa on TOP,
    CG at rtol 1e-13."""
    dev = on(pkg, device)
    grid = pkg.GridBox(nx=nx, ny=nx, nz=nx)
    eq = pkg.LinearMomentum(grid, theta=0.5, **dev)
    eq.set_solver(pkg.SolverSettings(method="cg", rtol=1e-13, max_it=500,
                                     fp32_phase=fp32_phase))
    n = eq.n_elems
    one = np.ones(n)
    mat = pkg.Material(n, **dev)
    mat.set_density(2000.0 * one)
    mat.add_to_elastic(pkg.Spring(102e9 * one, 0.3 * one))
    mat.add_to_non_elastic(pkg.DislocationCreep(1.9e-20 * one, 51600 * one,
                                                3.0 * one, **dev))
    eq.set_material(mat)
    eq.set_T0(298.0 * one)
    eq.set_T(298.0 * one)
    eq.build_body_force([0.0, 0.0, 0.0])
    momBC = pkg.MomentumBC
    bc = momBC.BcHandler(eq)
    tv = [0.0, 1e9]
    for nm, comp in (("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2)):
        bc.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.], tv))
    bc.add_boundary_condition(momBC.NeumannBC("TOP", 2, 0.0, 0.0,
                                              [10 * MPa, 10 * MPa], tv,
                                              g=0.0))
    eq.set_boundary_conditions(bc)
    return eq


def run_sharding_steps(eq, n_steps=2, dt=HOUR):
    """tests/test_sharding.py's ``_run_steps``: the elastic response, then
    ``n_steps`` per-step fixed points with the reference-style commit calls;
    returns (u, sig_v, rows of [iterations, error])."""
    elastic_init(eq)
    rows = []
    for k in range(n_steps):
        t = (k + 1) * dt
        rows.append(eq.solve_time_step(t, dt, tol=1e-8, maxiter=40))
        eq.update_internal_variables()
        eq.update_eps_ne_rate_old()
        eq.update_eps_ne_old(eq.sig_v, eq._last_sv_k, dt)
    return as_np(eq.u), as_np(eq.sig_v), np.asarray(rows, dtype=float)
