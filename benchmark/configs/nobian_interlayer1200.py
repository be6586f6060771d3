"""The nobian_interlayer1200 configuration on the program: a frozen copy
of ``build`` and ``set_bcs`` of
safeincave_torch/examples/mechanics/nobian_yearly/main.py (``--full``),
taking every number from ``nobian_interlayer1200.json``, and its two
stages up to the episode's start through ``Simulator_M``."""
from __future__ import annotations

import os

import numpy as np

import safeincave_torch as sc
import safeincave_torch.schedules as schedules

MPa = 1e6


def build(cfg, mesh_dir, device):
    """Mesh, region-masked material and equation."""
    grid = sc.GridHandlerGMSH("geom", mesh_dir, reorder=cfg["mesh"]["reorder"])
    regions = grid.get_subdomain_names()
    rules = cfg["regions"]

    def per_region(value):
        if not isinstance(value, dict):
            return value * np.ones(grid.n_elems)
        return np.asarray(grid.get_parameter(
            {r: value[next((g for sub, g in rules if sub in r), "default")]
             for r in regions}))

    spring, kv, dc, mc = cfg["materials"]
    n = grid.n_elems
    eq = sc.LinearMomentum(grid, theta=cfg["theta"], device=device)
    eq.set_solver(sc.SolverSettings(**cfg["solver"]))
    mat = sc.Material(n, device=device)
    mat.set_density(per_region(cfg["density"]))
    mat.add_to_elastic(sc.Spring(per_region(spring["E"]),
                                 per_region(spring["nu"])))
    mat.add_to_non_elastic(sc.Viscoelastic(
        per_region(kv["eta"]), per_region(kv["E"]), per_region(kv["nu"]),
        device=device))
    mat.add_to_non_elastic(sc.DislocationCreep(
        per_region(dc["A"]), per_region(dc["Q"]), per_region(dc["n_exp"]),
        name="ds_creep", device=device))
    mat.add_to_non_elastic(sc.MohrCoulombViscoplastic(
        mu_1=per_region(mc["mu_1"]), N_1=per_region(mc["N_1"]),
        cohesion=per_region(mc["cohesion"]),
        friction_angle=per_region(mc["friction_angle"]),
        dilation_angle=per_region(mc["dilation_angle"]),
        sigma_t=per_region(mc["sigma_t"]), name="mc_interlayer",
        device=device))
    eq.set_material(mat)
    eq.set_T0(cfg["temperature_K"] * np.ones(n))
    eq.set_T(cfg["temperature_K"] * np.ones(n))
    eq.build_body_force(cfg["gravity"])
    return eq


def set_bcs(cfg, eq, t_vals, p_vals):
    """Roller sides, the overburden on Top, the schedule on the cavern wall
    with the hydrostatic gas-column correction from the cavern's top."""
    grid = eq.grid
    momBC = sc.MomentumBC
    names = grid.get_boundary_names()
    cav, top = cfg["cavern"], cfg["overburden"]
    cav_tris = grid.tris[grid.get_boundary_tags(cav["face"])]
    z_cav_top = float(grid.points[np.unique(cav_tris)][:, 2].max())
    bc = momBC.BcHandler(eq)
    tv = [0.0, max(t_vals[-1], 1.0)]
    for nm, comp in cfg["supports"]:
        if nm in names:
            bc.add_boundary_condition(momBC.DirichletBC(nm, comp,
                                                        [0., 0.], tv))
    if top["face"] in names:
        bc.add_boundary_condition(momBC.NeumannBC(
            top["face"], 2, 0.0, 0.0, [top["pressure_Pa"]] * 2, tv, g=0.0))
    bc.add_boundary_condition(momBC.NeumannBC(
        cav["face"], 2, cav["fluid_density"], z_cav_top, list(p_vals),
        list(t_vals), g=cav["g"]))
    eq.set_boundary_conditions(bc)


def warm(eq, cfg, dt_h, start_h, root):
    """Stage 1, the equilibrium at a constant cavern pressure with the
    elastic response first; stage 2, the operation year from day 0 up to
    ``start_h`` at ``dt_h``, both through ``Simulator_M`` without outputs.
    Returns stage 2's time controller."""
    st = cfg["equilibrium"]
    tc = sc.TimeController(dt=st["dt_days"], initial_time=0.0,
                           final_time=st["days"], time_unit="day")
    p = st["pressure_Pa"]
    set_bcs(cfg, eq, [0.0, tc.t_final], [p, p])
    sc.Simulator_M(eq, tc, [], compute_elastic_response=True).run()

    op = cfg["operation"]
    year = sc.TimeController(dt=dt_h, initial_time=0.0,
                             final_time=op["days"] * 24.0, time_unit="hour")
    lo, hi = op["rescale_MPa"]
    t_vals, p_vals = schedules.build_csv_pressure_schedule(
        year, os.path.join(root, op["csv"]), days=op["days"],
        mode=op["mode"], total_cycles=1, rescale=True, rescale_min=lo,
        rescale_max=hi)
    set_bcs(cfg, eq, t_vals, p_vals)
    tc = sc.TimeController(dt=dt_h, initial_time=0.0, final_time=start_h,
                           time_unit="hour")
    sc.Simulator_M(eq, tc, [], compute_elastic_response=False).run()
    return tc
