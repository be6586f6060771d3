"""The interlayer1200_tm configuration on the program: a frozen copy of
bench_torch.py's ``build_tm_cyclic`` (bench.py's, interlayer branch:
dislocation creep masked off the interlayers and the overburden,
Mohr-Coulomb interlayers, the overburden pressure on Top, the cavern's
sinusoid, the heat ramp on Top and the Robin wall), taking every number
from ``interlayer1200_tm.json``; the warm stage is ``Simulator_TM``'s
elastic response at t = 0, as in ``regular1200_tm.py``.

``build`` returns (momentum equation, heat equation); ``warm`` takes that
pair."""
from __future__ import annotations

import numpy as np

import safeincave_torch as sc

HOUR = 3600.0


def tm_material(cfg, grid, device):
    """Spring, Kelvin-Voigt, dislocation creep, Mohr-Coulomb and
    Thermoelastic with the heat capacity and conductivity, each number per
    region by the configuration's ``regions`` rules."""
    regions = grid.get_subdomain_names()
    rules = cfg["regions"]

    def per_region(value):
        if not isinstance(value, dict):
            return value * np.ones(grid.n_elems)
        return np.asarray(grid.get_parameter(
            {r: value[next((g for sub, g in rules if sub in r), "default")]
             for r in regions}))

    spring, kv, dc, mc, th = cfg["materials"]
    heat = cfg["heat"]
    mat = sc.Material(grid.n_elems, device=device)
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
        sigma_t=per_region(mc["sigma_t"]), device=device))
    mat.add_to_thermoelastic(sc.Thermoelastic(per_region(th["alpha"]),
                                              device=device))
    mat.set_specific_heat_capacity(per_region(heat["specific_heat"]))
    mat.set_thermal_conductivity(per_region(heat["conductivity"]))
    return mat


def momentum_bcs(cfg, eq):
    """The supports, the overburden's constant pressure on Top and the
    sinusoidal pressure on the cavern wall."""
    momBC = sc.MomentumBC
    names = eq.grid.get_boundary_names()
    bc = momBC.BcHandler(eq)
    tv = [0.0, 1e12]
    for nm, comp in cfg["supports"]:
        if nm in names:
            bc.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.],
                                                        tv))
    ld = cfg["loads"]
    step = ld["sample_h"] * HOUR
    t_sched = np.arange(0.0, ld["samples"] * step, step)
    p_sched = ld["mean_Pa"] + ld["amplitude_Pa"] * np.sin(
        2 * np.pi * t_sched / (ld["period_h"] * HOUR))
    top = cfg["overburden"]
    for nm in top["faces"]:
        if nm in names:
            bc.add_boundary_condition(momBC.NeumannBC(
                nm, 2, 0.0, 0.0, [top["pressure_Pa"]] * 2, tv, g=0.0))
    for nm in ld["faces"]:
        if nm in names:
            bc.add_boundary_condition(momBC.NeumannBC(
                nm, 2, 0.0, 0.0, list(p_sched), list(t_sched), g=0.0))
    eq.set_boundary_conditions(bc)


def heat_equation(cfg, grid, mat, device):
    """The heat equation: CG, the initial temperature everywhere, the
    Dirichlet ramp on the first of its faces that the mesh has, the Robin
    wall."""
    spec = cfg["heat"]
    heatBC = sc.HeatBC
    heat = sc.HeatDiffusion(grid, device=device)
    heat.set_solver(sc.SolverSettings(**spec["solver"]))
    heat.set_material(mat)
    heat.set_initial_T(cfg["temperature_K"] * np.ones(grid.n_nodes))
    names = grid.get_boundary_names()
    bc = heatBC.BcHandler(heat)
    top = spec["dirichlet"]
    face = next((nm for nm in top["faces"] if nm in names), None)
    if face is not None:
        bc.add_boundary_condition(heatBC.DirichletBC(
            face, top["values_K"], top["times_s"]))
    wall = spec["robin"]
    if wall["face"] in names:
        bc.add_boundary_condition(heatBC.RobinBC(
            wall["face"], wall["values_K"], wall["h"], wall["times_s"]))
    heat.set_boundary_conditions(bc)
    return heat


def build(cfg, mesh_dir, device):
    """(momentum equation, heat equation) on the band-ordered mesh in
    ``mesh_dir``."""
    grid = sc.GridHandlerGMSH("geom", mesh_dir, reorder=cfg["mesh"]["reorder"])
    eq = sc.LinearMomentum(grid, theta=cfg["theta"], device=device)
    eq.set_solver(sc.SolverSettings(**cfg["solver"]))
    n = eq.n_elems
    mat = tm_material(cfg, grid, device)
    eq.set_material(mat)
    eq.set_T0(cfg["temperature_K"] * np.ones(n))
    eq.set_T(cfg["temperature_K"] * np.ones(n))
    eq.build_body_force(cfg["gravity"])
    momentum_bcs(cfg, eq)
    return eq, heat_equation(cfg, grid, mat, device)


def warm(built, cfg, dt_h, start_h, root):
    """The elastic response at t = 0 and the initial rates, through
    ``Simulator_TM`` with no step (``start_h`` is 0: a run of
    ``Simulator_TM`` starts a stage).  Returns its time controller."""
    eq, heat = built
    if start_h:
        raise ValueError("interlayer1200_tm: episodes start at t = 0, where "
                         "Simulator_TM starts a stage")
    tc = sc.TimeController(dt=dt_h, initial_time=0.0, final_time=0.0,
                           time_unit="hour")
    sc.Simulator_TM(eq, heat, tc, [], compute_elastic_response=True).run()
    return tc
