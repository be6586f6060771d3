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


def elastic_init(eq):
    """Elastic response + initial creep rates (the bench's init sequence)."""
    eq.bc.update_dirichlet(0.0)
    eq.bc.update_neumann(0.0)
    eq.solve_elastic_response()
    eps = eq.compute_total_strain()
    eq.compute_elastic_stress(eps)
    eq.compute_eps_ne_rate(eq.sig_v, 0.0)
    eq.update_eps_ne_rate_old()
