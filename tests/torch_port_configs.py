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
(``wire_tm``) take bench.py's second configuration (bench_tm), the
TM-cyclic ones (``tm_cyclic``) its ``build_tm_cyclic``; these benchmark
set-ups are bench_torch.py's functions, held against bench.py's own by
tests/test_torch_bench.py.  The yearly
production run (``yearly_*``) is examples/mechanics/nobian_yearly/main.py
``--full``; the calibration twins (``creep_model``, ``triaxial_twin``) are
those of examples/mechanics/MaterialCalibration.
"""
import contextlib
import dataclasses
import os
import re
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# bench_torch.py owns the benchmark's set-ups; its functions take the
# package module and set either package up
import bench_torch  # noqa: E402
from bench_torch import SETTINGS, on  # noqa: E402,F401

MPa = 1e6
HOUR = 3600.0


def bench_material(pkg, n, device=None):
    return bench_torch.bench_material(n, device, pkg)


def wire_bench(pkg, grid, precond="2level", fp32_phase=False, device=None,
               **eq_kw):
    """The cavern benchmark's equation on ``grid`` (fp32 phase off unless
    asked for)."""
    return bench_torch.bench_equation(grid, device, pkg, eq_kw,
                                      precond=precond, fp32_phase=fp32_phase)


def bench_bcs(pkg, eq):
    """The cavern benchmark's supports and 24 h sinusoidal pressure on
    ``eq``'s grid."""
    bench_torch.bench_bcs(eq, pkg)


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
    """bench.py's thermo-mechanical material (bench_tm)."""
    return bench_torch.tm_material(n, device, pkg)


def wire_tm(pkg, grid, wall, precond="2level", fp32_phase=False,
            device=None, heat_precision="mixed", **eq_kw):
    """bench.py's thermo-mechanical configuration on ``grid`` with the Robin
    wall on ``wall`` (:func:`bench_torch.tm_equations`).  Returns (momentum
    equation, heat equation)."""
    return bench_torch.tm_equations(grid, wall, device, pkg,
                                    heat_precision=heat_precision,
                                    eq_kw=eq_kw, precond=precond,
                                    fp32_phase=fp32_phase)


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
    mat = golden_material(pkg, n, device)
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


# -- bench.py's TM-cyclic configurations (BASELINE configs 4-5) ------------- #
# path name: (bench.py's grid name, its fallback, the baseline_measured.json
# row); bench.py:1106-1121 runs the three
TM_CYCLIC = {
    "tmcyc_regular1200": ("cavern_regular_1200_3D", "cavern_proxy_1200",
                          "regular1200_tm"),
    "tmcyc_interlayer600": ("cavern_interlayer_600_3D",
                            "cavern_interlayer_proxy", "interlayer600_tm"),
    "tmcyc_interlayer1200": ("cavern_interlayer_1200", None,
                             "interlayer1200_tm"),
}
TM_CYCLIC_STEPS = 10        # bench_tm_cyclic's steps after the first


def band_grid(pkg, grid_name, fallback=None):
    """The mesh ``grid_name`` (``fallback`` first in grids/, as bench.py
    finds it), band-ordered."""
    return pkg.GridHandlerGMSH("geom", pkg.Utils.find_grid(
        grid_name, fallback=fallback), reorder="band")


def tm_cyclic(pkg, grid_name, device=None, precond="2level",
              fp32_phase=False, auto_backend=True, fallback=None):
    """bench.py's ``build_tm_cyclic`` (:func:`bench_torch.build_tm_cyclic`,
    its quirks kept) on the band-ordered mesh ``grid_name``.  Returns
    (momentum equation, heat equation)."""
    return bench_torch.build_tm_cyclic(
        grid_name, fallback, device=device, pkg=pkg,
        eq_kw={"auto_backend": auto_backend}, precond=precond,
        fp32_phase=fp32_phase)


def tm_cyclic_path(pkg, path, **kw):
    """:func:`tm_cyclic` of a :data:`TM_CYCLIC` path name."""
    grid_name, fallback, _ = TM_CYCLIC[path]
    return tm_cyclic(pkg, grid_name, fallback=fallback, **kw)


# bench.py's init_tm (bench.py:684-700) is bench_tm's initial state
tm_cyclic_init = tm_init


def tm_cyclic_run(eq, heat, n_steps, t_first=HOUR):
    """bench_tm_cyclic's driver: ``solve_tm_time_steps`` at dt = 1 h, tol
    1e-6, 20 fixed-point iterations, ``n_steps`` steps from ``t_first``;
    returns the (n_steps, 6) stats rows."""
    return np.asarray(eq.solve_tm_time_steps(
        heat, [t_first + k * HOUR for k in range(n_steps)],
        [HOUR] * n_steps, tol=1e-6, maxiter=20))


SETUP_SKIP = {"eq", "heat", "grid", "kern", "kernel", "equation"}


def setup_arrays(eq, heat=None):
    """Everything a set-up gave ``eq`` and ``heat`` (of either package;
    ``heat`` may be None) as flat ``{path: numpy array}``: the material
    (its elements' parameters), the boundary handlers' tables, the solver
    settings, the initial temperatures and the body force.  Back-references
    to the equations, the grid and the kernels are left out, and so are the
    port's ``torch.device`` attributes; None and strings become strings."""
    out, seen = {}, set()

    def walk(obj, key):
        mod = type(obj).__module__
        if obj is None or isinstance(obj, (str, bool, int, float,
                                           np.number)):
            out[key] = np.asarray(str(obj) if obj is None else obj)
        elif mod.startswith(("numpy", "jax")):
            out[key] = np.asarray(obj)
        elif mod == "torch" and hasattr(obj, "detach"):
            out[key] = obj.detach().cpu().numpy()
        elif isinstance(obj, (list, tuple)):
            for i, x in enumerate(obj):
                walk(x, f"{key}.{i}")
        elif isinstance(obj, dict):
            for k in sorted(obj, key=str):
                walk(obj[k], f"{key}.{k}")
        elif mod.startswith(("safeincave_tpu", "safeincave_torch")) and \
                id(obj) not in seen:
            seen.add(id(obj))
            for k, v in sorted(vars(obj).items()):
                if k not in SETUP_SKIP and not k.startswith("_jit") \
                        and not callable(v):
                    walk(v, f"{key}.{k}")

    for key, obj in (("mat", eq.mat), ("bc", eq.bc), ("heat_bc", heat),
                     ("solver", eq.solver), ("heat_solver", heat),
                     ("T0", eq.T0), ("Temp", eq.Temp), ("b_body", eq.b_body),
                     ("heat_T", heat)):
        if key.startswith("heat"):
            if heat is None:
                continue
            obj = getattr(heat, key[5:])
        walk(obj, key)
    return out


# a cache the port fills when the material is set and the JAX package on
# first use
CACHES = {"mat._CT_el"}


def private(key):
    """Whether a set-up key is a cache or a device attribute of one package
    (a path component with a leading underscore, or ``device``)."""
    return any(p.startswith("_") or p == "device" for p in key.split("."))


def assert_same_setup(got, ref):
    """Two set-ups' :func:`setup_arrays` equal array for array, but for one
    package's caches and device attributes; returns the keys compared."""
    only = set(got) ^ set(ref)
    assert all(private(k) for k in only), sorted(only)
    common = sorted((set(got) & set(ref)) - CACHES)
    for k in common:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    return common


def tm_cyclic_fields(eq, heat, pq=False):
    """What the TM-cyclic goldens keep of a state: u, T and sig_v, or
    with ``pq`` the mean stress and the von Mises stress per element in
    sig_v's place (a third of its bytes)."""
    out = {"u": as_np(eq.u), "T": as_np(heat.T)}
    sig = as_np(eq.sig_v)
    if not pq:
        return {**out, "sig_v": sig}
    d = sig[:, :3] - sig[:, :3].mean(axis=1, keepdims=True)
    return {**out, "p": sig[:, :3].mean(axis=1),
            "q": np.sqrt(1.5 * (d ** 2).sum(axis=1)
                         + 3.0 * (sig[:, 3:] ** 2).sum(axis=1))}


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
    """tests/test_sharding.py's ``_run_steps`` (and, with ``n_steps=3``,
    tests/golden_configs.py's ``run_mechanics``): the elastic response,
    then ``n_steps`` per-step fixed points (tol 1e-8, 40 iterations) with
    the reference-style commit calls; returns (u, sig_v, rows of
    [iterations, error])."""
    elastic_init(eq)
    rows = []
    for k in range(n_steps):
        t = (k + 1) * dt
        rows.append(eq.solve_time_step(t, dt, tol=1e-8, maxiter=40))
        eq.update_internal_variables()
        eq.update_eps_ne_rate_old()
        eq.update_eps_ne_old(eq.sig_v, eq._last_sv_k, dt)
    return as_np(eq.u), as_np(eq.sig_v), np.asarray(rows, dtype=float)


# -- the examples tree (examples/ and its twins in safeincave_torch/examples) #
EXAMPLE_TREES = {"safeincave_tpu": os.path.join(ROOT, "examples"),
                 "safeincave_torch": os.path.join(ROOT, "safeincave_torch",
                                                  "examples")}
YEARLY_OUT = os.path.join("output", "nobian_yearly")
# name: (script, main's arguments in the CPU tests, on the card).  The card
# runs each script's defaults but two: nobian_yearly at its CI scale (the
# documented "--dt-days 2" on the generated cavern, mesh_n 8) cut in depth
# from 365 to 120 days, 60 steps and a checkpoint at step 32 (--full is
# chip_smoke.py's phase 13); thermomechanics/2_cavern, on
# :func:`overburden_standin`, with its operation cut from 240 to 40 days
# (80 steps at 0.5 day, one pressure cycle) so that its JAX golden runs in
# minutes on the CPU.
EXAMPLE_RUNS = {
    "thermal_cube": ("thermal/1_cube/main.py", {}, {}),
    "triaxial": ("mechanics/1_triaxial/main.py",
                 {"final_time": 2.0, "dt": 0.5}, {}),
    "cube_regions": ("mechanics/2_cube_regions/main.py", {}, {}),
    "tm_cube": ("thermomechanics/1_cube/main.py", {}, {}),
    "cavern": ("mechanics/4_cavern/main.py",
               {"eq_hours": 2.0, "eq_dt": 1.0, "op_hours": 2.0,
                "op_dt": 1.0}, {}),
    "thermal_cavern": ("thermal/2_cavern/main.py",
                       {"n_time_steps": 3, "final_time": 0.1,
                        "time_unit": "day"}, {}),
    "interlayer": ("mechanics/nobian_interlayer/main.py",
                   {"operation_days": 0.25, "dt_hours": 2.0}, {}),
    "yearly": ("mechanics/nobian_yearly/main.py",
               {"argv": ["--days", "20", "--dt-hours", "12", "--mesh-n",
                         "5", "--mode", "stretch", "--out", YEARLY_OUT]},
               {"argv": ["--days", "120", "--dt-days", "2",
                         "--out", YEARLY_OUT]}),
    "tm_cavern": ("thermomechanics/2_cavern/main.py",
                  {"n_eq_steps": 2, "eq_days": 1.0, "op_days": 0.5},
                  {"op_days": 40.0}),
}
# 1_triaxial with the f32 sweep forced on in both packages (on CUDA the
# script's "auto" turns it on; the CPU keeps it off), at the CPU tests'
# arguments and, on the card, at the script's defaults (48 steps)
SWEEP_RUNS = {"triaxial_sweep": EXAMPLE_RUNS["triaxial"]}


def example_kwargs(pkg, name, kwargs, grid_root):
    """``kwargs`` of the example ``name`` with the mesh folder it needs
    written under ``grid_root``: the stand-in overburden mesh for
    thermomechanics/2_cavern, the reference-named proxy for the JAX
    package's thermal/2_cavern (the port's twin finds the proxy itself)."""
    if name == "tm_cavern":
        return {**kwargs, "grid_dir": overburden_standin(pkg, grid_root)}
    if name == "thermal_cavern" and pkg.__name__ == "safeincave_tpu":
        return {**kwargs, "grid_dir": reference_named_proxy(grid_root)}
    return kwargs


@contextlib.contextmanager
def fp32_forced(pkg, value, **settings):
    """While active, every momentum equation of ``pkg`` gets
    ``fp32_phase=value`` (and ``settings``) in its solver settings,
    whatever the script asked for."""
    base = pkg.LinearMomentumBase
    real = base.set_solver

    def set_solver(self, solver):
        real(self, dataclasses.replace(solver, fp32_phase=value,
                                       **settings))
    base.set_solver = set_solver
    try:
        yield
    finally:
        base.set_solver = real
# the calibration scripts: (script, Adam steps on the card)
CALIBRATIONS = {"creep": "mechanics/MaterialCalibration/calibrate_creep.py",
                "labdata": "mechanics/MaterialCalibration/"
                           "calibrate_labdata.py",
                "triaxial_fit": "mechanics/MaterialCalibration/"
                                "calibrate_triaxial.py",
                "multimodel": "mechanics/MaterialCalibration/"
                              "calibrate_multimodel.py"}
TRIAXIAL_FIT_STEPS = 1
MULTIMODEL_STEPS = 2


def load_example(pkg_name, script):
    """The globals of an example script (``examples/`` for the JAX package,
    ``safeincave_torch/examples/`` for the port), loaded as a module that
    is not ``__main__``."""
    import runpy
    import sys
    path = os.path.join(EXAMPLE_TREES[pkg_name], script)
    sys.path.insert(0, os.path.dirname(path))
    try:
        return runpy.run_path(path, run_name="example")
    finally:
        sys.path.pop(0)


def run_example(pkg_name, script, cwd, kwargs, device=None):
    """Run an example's ``main(**kwargs)`` with ``cwd`` as the working
    directory (its outputs land under ``cwd/output``); the port's twin
    gets ``device``.  Returns main's result."""
    mod = load_example(pkg_name, script)
    if pkg_name == "safeincave_torch":
        kwargs = {**kwargs, "device": device}
    old = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        return mod["main"](**kwargs)
    finally:
        os.chdir(old)


def example_record(out_root, read_timeseries):
    """What the example goldens keep of a run's outputs under
    ``out_root``: per saved field (``<folder>.<field>`` relative to
    ``out_root``, "/" as ".") the last save and the save times, and per
    transcript (``<folder>.log``) the iteration column of its step rows."""
    rec = {}
    for base, _, files in sorted(os.walk(out_root)):
        for f in sorted(files):
            rel = os.path.relpath(base, out_root).replace(os.sep, ".")
            if f.endswith(".xdmf"):
                folder = os.path.dirname(base)
                name = f[:-len(".xdmf")]
                t, v, _, _ = read_timeseries(folder, name)
                key = rel.rpartition(".")[0] if "." in rel else ""
                key = f"{key}.{name}" if key else name
                rec[key] = np.asarray(v[-1])
                rec[f"{key}.times"] = np.asarray(t, dtype=float)
            elif f == "log.txt":
                with open(os.path.join(base, f)) as fh:
                    rows = screen_rows(fh.read().splitlines())
                rec[f"{rel}.log" if rel != "." else "log"] = rows[:, 0]
    return rec


def reference_named_proxy(dst):
    """grids/cavern_proxy_600 written to ``dst/geom.msh`` with its faces
    named as the reference's cavern_regular_600_3D names them ("Top",
    "West", ...): the mesh examples/thermal/2_cavern/main.py expects.  The
    port's twin runs on the proxy itself and finds the faces in either
    case."""
    src = os.path.join(ROOT, "grids", "cavern_proxy_600", "geom.msh")
    with open(src) as f:
        text = f.read()
    for face in ("WEST", "EAST", "SOUTH", "NORTH", "BOTTOM", "TOP"):
        text = text.replace(f'"{face}"', f'"{face.title()}"')
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(dst, "geom.msh"), "w") as f:
        f.write(text)
    return dst


OVERBURDEN_GRID = "cavern_overburden_coarse"
SIDES = ("West", "East", "South", "North")


def overburden_standin(pkg, folder):
    """A stand-in for the reference's cavern_overburden_coarse mesh, which
    examples/thermomechanics/2_cavern/main.py needs and the repository
    does not hold: ``pkg``'s catalog synthesis of that name (cavern_gen's
    "overburden" family: a Salt body under an Overburden cap above z =
    _Z1 + 110), each side face split into ``<side>_salt`` / ``<side>_ovb``
    by its facet's centroid against the cap's level, written to
    ``folder/geom.msh`` with ``pkg``'s ``write_msh``; beside it a
    ``geom.geo`` whose lines 11-13 give ``ovb_thickness``,
    ``salt_thickness`` and ``hanging_wall`` (cap's level less the
    cavern's roof) as the script parses them.  It is not the reference's
    mesh.  Returns ``folder``."""
    from importlib import import_module
    cg = import_module(pkg.__name__ + ".mesh.cavern_gen")
    points, tets, tet_tags, tris, tri_tags, fd = cg._catalog_mesh_arrays(
        OVERBURDEN_GRID)
    z_ovb = cg._shape_family(cg.parse_grid_name(OVERBURDEN_GRID)[0])[2]
    above = points[tris].mean(axis=1)[:, 2] > z_ovb
    tag = max(t for t, _ in fd.values()) + 1
    tri_tags = np.asarray(tri_tags).copy()
    new_tags = tri_tags.copy()
    for side in SIDES:
        old = fd.pop(side)[0]
        for suffix, where in (("salt", ~above), ("ovb", above)):
            fd[f"{side}_{suffix}"] = (tag, 2)
            new_tags[(tri_tags == old) & where] = tag
            tag += 1
    os.makedirs(folder, exist_ok=True)
    pkg.mesh.write_msh(os.path.join(folder, "geom.msh"), points, tets,
                       tet_tags, tris, new_tags, fd)
    z_top = float(points[:, 2].max())
    roof = float(points[np.unique(tris[tri_tags == fd["Cavern"][0]])][:, 2]
                 .max())
    lines = ["// Stand-in for cavern_overburden_coarse, synthesized by",
             f"// {pkg.__name__}.mesh.cavern_gen (family \"overburden\");",
             "// only the layer thicknesses below are read.", "//", "//",
             "//", "//", "//", "//", "//",
             f"ovb_thickness = {z_top - z_ovb!r};",
             f"salt_thickness = {z_ovb!r};",
             f"hanging_wall = {z_ovb - roof!r};"]
    with open(os.path.join(folder, "geom.geo"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return folder



# -- the original stack's oracle and tests/golden/fields.npz's snapshots ---- #
ORACLE = os.path.join(ROOT, "tests", "files", "expected_values_equations",
                      "expected_values.json")
CUBE_COARSE = os.path.join(ROOT, "tests", "files", "cube_coarse")
FIELDS_GOLDEN = os.path.join(ROOT, "tests", "golden", "fields.npz")
# what the JAX package chose on the CPU where these references were made:
# the 2level preconditioner, no f32 sweep and the cumsum operator; the
# port's CUDA "auto" picks otherwise
PINNED = {"precond": "2level", "fp32_phase": False}


def pinned_kw(pin):
    """(solver settings, equation arguments) of a conformance builder:
    :data:`PINNED` and no automatic backend when ``pin``, else the
    defaults."""
    return (dict(PINNED), {"auto_backend": False}) if pin else ({}, {})


def resolved(eq):
    """What a momentum equation of either package runs with once its
    "auto" settings are resolved on its device: (its preconditioner's
    arrays as numpy, whether the f32 sweep runs, whether the band operator
    is on, whether the block-DIA operator is on)."""
    P, _ = eq._get_precond()
    port = type(eq).__module__.startswith("safeincave_torch")
    fp32 = (eq.solver.fp32_enabled(eq.device) if port
            else eq.solver.fp32_enabled())
    return ([as_np(a) for a in P], fp32, eq.kernel.band is not None,
            eq.kernel.dia is not None)


def oracle_cube(pkg, device=None, pin=False):
    """tests/test_reference_oracle.py's set-up for either package: the
    two-region cube_coarse mesh, the fully implicit theta = 0, CG at f64 and
    rtol 1e-14, Spring + Kelvin-Voigt + dislocation creep (T = 293 K) +
    Desai, gravity, rollers on WEST/SOUTH/BOTTOM and 4 / 4 / 4.1 MPa on
    NORTH/EAST/TOP, then the elastic response and its stress.  Returns
    (equation, the Desai element)."""
    dev = on(pkg, device)
    solver_kw, eq_kw = pinned_kw(pin)
    grid = pkg.GridHandlerGMSH("geom", CUBE_COARSE)
    n = grid.n_elems
    one = np.ones(n)
    eq = pkg.LinearMomentum(grid, theta=0.0, **eq_kw, **dev)
    eq.set_solver(pkg.SolverSettings(method="cg", rtol=1e-14, max_it=2000,
                                     precision="f64", **solver_kw))
    mat = pkg.Material(n, **dev)
    mat.set_density(2000.0 * one)
    mat.add_to_elastic(pkg.Spring(102e9 * one, 0.3 * one))
    mat.add_to_non_elastic(pkg.Viscoelastic(10.5e12 * one, 10e9 * one,
                                            0.32 * one, **dev))
    mat.add_to_non_elastic(pkg.DislocationCreep(1.9e-20 * one, 51600 * one,
                                                3.0 * one, **dev))
    desai = pkg.ViscoplasticDesai(
        mu_1=5.366585700985981e-11 * one, N_1=3.1 * one,
        a_1=1.965018496922832e-05 * one, eta=0.8275682807874163 * one,
        n=3.0 * one, beta_1=0.0048 * one, beta=0.995 * one, m=-0.5 * one,
        gamma=0.095 * one, sigma_t=5.0 * one, alpha_0=0.0022 * one, **dev)
    mat.add_to_non_elastic(desai)
    eq.set_material(mat)
    eq.set_T0(293.0 * one)
    eq.set_T(293.0 * one)
    eq.build_body_force([0.0, 0.0, -9.81])
    momBC = pkg.MomentumBC
    tv = [0.0, 7200.0]
    bc = momBC.BcHandler(eq)
    for nm, comp in (("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2)):
        bc.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.], tv))
    for nm, p in (("NORTH", 4.0), ("EAST", 4.0), ("TOP", 4.1)):
        bc.add_boundary_condition(momBC.NeumannBC(
            nm, 0, 0.0, 0.0, [p * MPa, p * MPa], tv, g=0.0))
    eq.set_boundary_conditions(bc)
    eq.bc.update_dirichlet(0.0)
    eq.bc.update_neumann(0.0)
    eq.solve_elastic_response()
    eps = eq.compute_total_strain()
    eq.compute_elastic_stress(eps)
    return eq, desai


def oracle_step(eq, desai):
    """tests/test_reference_oracle.py's one nonlinear step: Desai's initial
    hardening from the elastic stress, the initial rates, then one step of
    3600 s from t = 0 (tol 1e-9, 60 iterations).  Returns (iterations,
    error)."""
    desai.compute_initial_hardening(eq.sig_v)
    eq.compute_eps_ne_rate(eq.sig_v, 0.0)
    eq.update_eps_ne_rate_old()
    return eq.solve_time_step(0.0, 3600.0, tol=1e-9, maxiter=60)


def oracle_run(pkg, device=None, pin=False):
    """:func:`oracle_cube` and :func:`oracle_step` of ``pkg`` as numpy: u,
    the total strain (tensorial Voigt) and Desai's alpha after the elastic
    response (alpha after the initial hardening) and after the step, and
    the step's iterations and error."""
    eq, desai = oracle_cube(pkg, device, pin)
    run = {"u_elastic": np.array(as_np(eq.u)),
           "eps_elastic": np.array(as_np(eq.compute_total_strain()))}
    desai.compute_initial_hardening(eq.sig_v)
    run["alpha_elastic"] = np.array(as_np(desai.state["alpha"]))
    ite, err = oracle_step(eq, desai)
    run.update(u_step=np.array(as_np(eq.u)),
               eps_step=np.array(as_np(eq.eps_tot_v)),
               alpha_step=np.array(as_np(desai.state["alpha"])),
               iterations=np.asarray(ite), error=np.asarray(err))
    return run


# tests/test_reference_oracle.py's checks: (oracle key, oracle_run key,
# tolerance on sorted magnitudes, or on the signed 9-component multiset for
# a strain); the oracle kept alpha frozen over its first step
ORACLE_CHECKS = (("u_0", "u_elastic", 5e-7),
                 ("eps_tot_0", "eps_elastic", 5e-6),
                 ("alpha_0", "alpha_elastic", 2e-6),
                 ("alpha_1", "alpha_elastic", 2e-6),
                 ("u_1", "u_step", 5e-7), ("eps_tot_1", "eps_step", 5e-6))


def oracle_distance(run, oracle, key):
    """The distance of :func:`oracle_run`'s field to the oracle's ``key``,
    as tests/test_reference_oracle.py measures it."""
    name = dict((k, r) for k, r, _ in ORACLE_CHECKS)[key]
    if key.startswith("eps"):
        return strain_multiset_rel(run[name], oracle[key])
    return sorted_rel(run[name], oracle[key])


def sorted_rel(got, want):
    """Largest distance of two value multisets (magnitudes sorted) over
    max|want|: the comparison the oracle allows, its node order being
    dolfin's."""
    got = np.sort(np.abs(as_np(got).reshape(-1)))
    want = np.sort(np.abs(np.asarray(want).reshape(-1)))
    return float(np.abs(got - want).max() / np.abs(want).max())


def strain_multiset_rel(eps_v, want):
    """:func:`sorted_rel`'s signed twin for a total strain: the tensorial
    Voigt rows expanded to the 9 components the oracle froze (each shear
    twice), sorted."""
    ev = as_np(eps_v)
    got = np.sort(np.concatenate([ev[:, :3], ev[:, 3:], ev[:, 3:]],
                                 axis=1).reshape(-1))
    want = np.sort(np.asarray(want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def golden_material(pkg, n, device=None):
    """tests/golden_configs.py's ``_material`` (Spring + Kelvin-Voigt +
    dislocation creep) for either package."""
    dev = on(pkg, device)
    one = np.ones(n)
    mat = pkg.Material(n, **dev)
    mat.set_density(2200.0 * one)
    mat.add_to_elastic(pkg.Spring(102e9 * one, 0.3 * one))
    mat.add_to_non_elastic(pkg.Viscoelastic(105e11 * one, 10e9 * one,
                                            0.32 * one, **dev))
    mat.add_to_non_elastic(pkg.DislocationCreep(1.9e-20 * one, 51600 * one,
                                                3.0 * one, **dev))
    return mat


def cavern_box(pkg, device=None, pin=False):
    """tests/golden_configs.py's ``build_cavern_box`` for either package:
    a 100 x 100 x 200 m box of 4 x 4 x 4 cells, Spring + Kelvin-Voigt + dislocation creep,
    gravity, rollers on the five other faces and a hydrostatic column on
    TOP (10-12 MPa plus 800 kg/m^3 from z = 200 m), BiCGStab at 1e-12."""
    dev = on(pkg, device)
    solver_kw, eq_kw = pinned_kw(pin)
    grid = pkg.GridBox(Lx=100.0, Ly=100.0, Lz=200.0, nx=4, ny=4, nz=4)
    eq = pkg.LinearMomentum(grid, theta=0.5, **eq_kw, **dev)
    eq.set_solver(pkg.SolverSettings(method="bicgstab", rtol=1e-12,
                                     max_it=500, **solver_kw))
    n = eq.n_elems
    eq.set_material(golden_material(pkg, n, device))
    eq.set_T0(298.0 * np.ones(n))
    eq.set_T(298.0 * np.ones(n))
    eq.build_body_force([0.0, 0.0, -9.81])
    momBC = pkg.MomentumBC
    bc = momBC.BcHandler(eq)
    tv = [0.0, 1e9]
    for nm, comp in (("WEST", 0), ("EAST", 0), ("SOUTH", 1), ("NORTH", 1),
                     ("BOTTOM", 2)):
        bc.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.], tv))
    bc.add_boundary_condition(momBC.NeumannBC(
        "TOP", 2, density=800.0, ref_pos=200.0,
        values=[10 * MPa, 12 * MPa], time_values=tv, g=-9.81))
    eq.set_boundary_conditions(bc)
    return eq


def interlayer_tm(pkg, device=None, pin=False):
    """tests/golden_configs.py's ``build_interlayer_tm`` for either
    package, on ``pkg``'s own cavern generator: the revolved-profile cavern
    (n = 5) with two dipping interlayer bands, dislocation creep in the
    salt and Mohr-Coulomb viscoplasticity in the interlayers (each masked
    by region), Thermoelastic, a cooling Dirichlet Top and Robin cavern wall
    for the heat equation, 15 MPa on Top and a 24 h sinusoidal cavern
    pressure.  Returns (momentum, heat)."""
    from importlib import import_module
    cg = import_module(pkg.__name__ + ".mesh.cavern_gen")
    dev = on(pkg, device)
    solver_kw, eq_kw = pinned_kw(pin)
    grid = cg.GridCavern(L=450.0, H=660.0, n=5, interlayers=[
        cg.InterlayerBand(250.0, 40.0, dip_deg=8.0),
        cg.InterlayerBand(430.0, 35.0, dip_deg=-5.0)])
    n_el = grid.n_elems
    one = np.ones(n_el)
    inter = np.asarray(grid.get_parameter(
        {r: (1.0 if r.startswith("Interlayer") else 0.0)
         for r in grid.get_subdomain_names()}))
    salt = 1.0 - inter

    heat = pkg.HeatDiffusion(grid, **dev)
    heat.set_solver(pkg.SolverSettings(method="cg", rtol=1e-12, max_it=500))
    mat = pkg.Material(n_el, **dev)
    mat.set_density(2200.0 * salt + 2900.0 * inter)
    mat.add_to_elastic(pkg.Spring(102e9 * salt + 70e9 * inter,
                                  0.30 * salt + 0.27 * inter))
    mat.add_to_non_elastic(pkg.DislocationCreep(
        1.9e-20 * salt, 51600 * one, 3.0 * one, name="ds_creep", **dev))
    mat.add_to_non_elastic(pkg.MohrCoulombViscoplastic(
        mu_1=1e-9 * inter, N_1=1.0 * one, cohesion=4.0 * one,
        friction_angle=np.radians(35.0) * one,
        dilation_angle=0.0 * one, sigma_t=1.0 * one, **dev))
    mat.add_to_thermoelastic(pkg.Thermoelastic(4.4e-5 * one, **dev))
    mat.set_specific_heat_capacity(850.0 * one)
    mat.set_thermal_conductivity(7.0 * one)
    heat.set_material(mat)
    heat.set_initial_T(298.0 * np.ones(grid.n_nodes))
    heatBC = pkg.HeatBC
    bc_h = heatBC.BcHandler(heat)
    tv3 = [0.0, 12 * HOUR, 1e9]
    bc_h.add_boundary_condition(heatBC.DirichletBC("Top", [298., 295., 295.],
                                                   tv3))
    bc_h.add_boundary_condition(heatBC.RobinBC("Cavern", [298., 290., 290.],
                                               5.0, tv3))
    heat.set_boundary_conditions(bc_h)

    eq = pkg.LinearMomentum(grid, theta=0.5, **eq_kw, **dev)
    eq.set_solver(pkg.SolverSettings(method="bicgstab", rtol=1e-12,
                                     max_it=500, **solver_kw))
    eq.set_material(mat)
    eq.build_body_force([0.0, 0.0, 0.0])
    momBC = pkg.MomentumBC
    bc_m = momBC.BcHandler(eq)
    tv = [0.0, 1e9]
    for nm, comp in (("West", 0), ("East", 0), ("South", 1), ("North", 1),
                     ("Bottom", 2)):
        bc_m.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.],
                                                      tv))
    t_sched = list(np.arange(0.0, 80 * HOUR, HOUR))
    p_sched = list(8 * MPa + 2 * MPa
                   * np.sin(2 * np.pi * np.asarray(t_sched) / (24 * HOUR)))
    bc_m.add_boundary_condition(momBC.NeumannBC("Top", 2, 0.0, 0.0,
                                                [15 * MPa, 15 * MPa], tv,
                                                g=0.0))
    bc_m.add_boundary_condition(momBC.NeumannBC("Cavern", 2, 0.0, 0.0,
                                                p_sched, t_sched, g=0.0))
    eq.set_boundary_conditions(bc_m)
    return eq, heat


# -- the Python blocks of the port's migration page ------------------------ #
MIGRATION = os.path.join(ROOT, "docs", "MIGRATION_TORCH.md")


def migration_blocks(path=MIGRATION):
    """The ```python blocks of docs/MIGRATION_TORCH.md, in order."""
    with open(path) as f:
        return re.findall(r"^```python\n(.*?)^```", f.read(), re.M | re.S)


def run_migration_blocks(device, cwd):
    """Run every Python block of docs/MIGRATION_TORCH.md in order, in one
    namespace that holds ``device``, with ``cwd`` as the working directory
    (the blocks write their files there).  Returns the namespace."""
    ns = {"__name__": "migration", "device": device}
    old = os.getcwd()
    os.chdir(cwd)
    try:
        for i, block in enumerate(migration_blocks()):
            exec(compile(block, f"{MIGRATION}:block{i + 1}", "exec"), ns)
    finally:
        os.chdir(old)
    return ns
