"""Problem set-up shared by the PyTorch-port parity tests, the port's
golden generator and chip_smoke.py.

Each function takes the package module (``safeincave_tpu`` or
``safeincave_torch``), whose public APIs match, so both packages are set up
from identical inputs.  ``device`` places the port's objects (its entry
points run on the card unless given ``device="cpu"``, as the tests do); the
JAX package takes no such argument.  The material and loads are the cavern
benchmark's (bench.py:build): Spring + Viscoelastic + DislocationCreep +
ViscoplasticDesai, roller supports on the three lower faces and a 24 h
sinusoidal pressure on the loaded faces.
"""
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
    momBC = pkg.MomentumBC
    names = grid.get_boundary_names()
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
    return eq


def cavern600_grid(pkg):
    path = pkg.Utils.find_grid("cavern_regular_600_3D",
                               fallback="cavern_proxy_600")
    return pkg.GridHandlerGMSH("geom", path, reorder="band")


def box17_grid(pkg):
    """bench.py's box configuration (its fallback when no cavern mesh is
    found), in natural order: 5,832 nodes, 29,478 tets."""
    return pkg.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=17, ny=17, nz=17)


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


def elastic_init(eq):
    """Elastic response + initial creep rates (the bench's init sequence)."""
    eq.bc.update_dirichlet(0.0)
    eq.bc.update_neumann(0.0)
    eq.solve_elastic_response()
    eps = eq.compute_total_strain()
    eq.compute_elastic_stress(eps)
    eq.compute_eps_ne_rate(eq.sig_v, 0.0)
    eq.update_eps_ne_rate_old()
