"""The cavern600_desai configuration on the program: a frozen copy of
bench_torch.py's ``bench_material``, ``bench_bcs``, ``bench_equation`` and
``build`` (themselves bench.py's ``build()``), taking every number from
``cavern600_desai.json``, and the warm-up through ``Simulator_M``."""
from __future__ import annotations

import numpy as np

import safeincave_torch as sc

HOUR = 3600.0


def bench_material(cfg, n, device):
    """Spring + Kelvin-Voigt + dislocation creep + Desai on ``n``
    elements."""
    one = np.ones(n)
    spring, kv, dc, desai = cfg["materials"]
    mat = sc.Material(n, device=device)
    mat.set_density(cfg["density"] * one)
    mat.add_to_elastic(sc.Spring(spring["E"] * one, spring["nu"] * one))
    mat.add_to_non_elastic(sc.Viscoelastic(kv["eta"] * one, kv["E"] * one,
                                           kv["nu"] * one, device=device))
    mat.add_to_non_elastic(sc.DislocationCreep(dc["A"] * one, dc["Q"] * one,
                                               dc["n_exp"] * one,
                                               device=device))
    mat.add_to_non_elastic(sc.ViscoplasticDesai(
        **{k: v * one for k, v in desai.items() if k != "type"},
        device=device))
    return mat


def bench_bcs(cfg, eq):
    """The supports (the first boundary pinned in all components when no
    face has a known name) and the sinusoidal pressure on the loaded
    faces."""
    momBC = sc.MomentumBC
    names = eq.grid.get_boundary_names()
    bc = momBC.BcHandler(eq)
    tv = [0.0, 1e12]
    fixed = [(nm, comp) for nm, comp in cfg["supports"] if nm in names] \
        or [(names[0], comp) for comp in range(3)]
    for nm, comp in fixed:
        bc.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.], tv))
    ld = cfg["loads"]
    step = ld["sample_h"] * HOUR
    t_sched = np.arange(0.0, ld["samples"] * step, step)
    p_sched = ld["mean_Pa"] + ld["amplitude_Pa"] * np.sin(
        2 * np.pi * t_sched / (ld["period_h"] * HOUR))
    for nm in ld["faces"]:
        if nm in names:
            bc.add_boundary_condition(momBC.NeumannBC(
                nm, 2, 0.0, 0.0, list(p_sched), list(t_sched), g=0.0))
    eq.set_boundary_conditions(bc)


def build(cfg, mesh_dir, device):
    """The benchmark equation on the band-ordered mesh in ``mesh_dir``."""
    grid = sc.GridHandlerGMSH("geom", mesh_dir, reorder=cfg["mesh"]["reorder"])
    eq = sc.LinearMomentum(grid, theta=cfg["theta"], device=device)
    eq.set_solver(sc.SolverSettings(**cfg["solver"]))
    n = eq.n_elems
    eq.set_material(bench_material(cfg, n, device))
    eq.set_T0(cfg["temperature_K"] * np.ones(n))
    eq.set_T(cfg["temperature_K"] * np.ones(n))
    eq.build_body_force(cfg["gravity"])
    bench_bcs(cfg, eq)
    return eq


def warm(eq, cfg, dt_h, start_h, root):
    """The elastic response, then ``start_h`` hours at ``dt_h`` through
    ``Simulator_M`` without outputs; returns its time controller."""
    tc = sc.TimeController(dt=dt_h, initial_time=0.0, final_time=start_h,
                           time_unit="hour")
    sc.Simulator_M(eq, tc, [], compute_elastic_response=True).run()
    return tc
