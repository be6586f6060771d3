"""Salt-cavern simulation: geostatic equilibrium -> cyclic-pressure operation.

The port's twin of examples/mechanics/4_cavern/main.py: stage 1
establishes the lithostatic stress state under constant BCs; stage 2 starts
from it (compute_elastic_response=False) and applies a cyclic hydrostatic
cavern-pressure schedule on the cavern wall.

Uses the reference's cavern_regular_600_3D mesh when a mounted copy is
found (``find_grid``); otherwise the repository's grids/cavern_proxy_600,
in file order.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

import safeincave_torch as sc  # noqa: E402
import safeincave_torch.utils as ut  # noqa: E402
from safeincave_torch.utils import find_grid  # noqa: E402

momBC = sc.MomentumBC


def build_equation(device=None):
    grid_dir = find_grid("cavern_regular_600_3D", fallback="cavern_proxy_600")
    grid = sc.GridHandlerGMSH("geom", grid_dir)
    if os.path.basename(grid_dir) == "cavern_proxy_600":
        names = dict(west="WEST", south="SOUTH", bottom="BOTTOM",
                     east="EAST", north="NORTH", top="TOP", cavern="Cavern")
    else:
        names = dict(west="West", south="South", bottom="Bottom",
                     east="East", north="North", top="Top", cavern="Cavern")

    eq = sc.LinearMomentum(grid, theta=0.5, device=device)
    eq.set_solver(sc.SolverSettings(method="bicgstab", rtol=1e-12,
                                    max_it=2000))
    n = grid.n_elems
    one = np.ones(n)
    mat = sc.Material(n, device=device)
    mat.set_density(2200.0 * one)
    mat.add_to_elastic(sc.Spring(20.38e9 * one, 0.33 * one, "spring"))
    mat.add_to_non_elastic(sc.DislocationCreep(1.9e-20 * one, 51600 * one,
                                               3.0 * one, "creep",
                                               device=device))
    eq.set_material(mat)
    eq.set_T0(298.0 * one)
    eq.set_T(298.0 * one)
    eq.build_body_force([0.0, 0.0, -9.81])
    return grid, eq, names


def lithostatic_bcs(eq, names, tv, p_top):
    """Roller sides + overburden on top (constant over tv)."""
    bc = momBC.BcHandler(eq)
    for nm, comp in ((names["west"], 0), (names["east"], 0),
                     (names["south"], 1), (names["north"], 1),
                     (names["bottom"], 2)):
        bc.add_boundary_condition(momBC.DirichletBC(nm, comp,
                                                    [0.0] * len(tv), tv))
    bc.add_boundary_condition(momBC.NeumannBC(
        names["top"], 2, 0.0, 0.0, [p_top] * len(tv), tv, g=0.0))
    return bc


def main(eq_hours=24.0, eq_dt=2.0, op_hours=48.0, op_dt=1.0, device=None):
    grid, eq, names = build_equation(device)
    out_root = "output"
    p_top = 10 * ut.MPa
    H_cavern = 430.0          # brine column reference elevation
    rho_fluid = 8.01942       # kg/m3-equivalent gas column density

    # ---- stage 1: equilibrium ---------------------------------------- #
    tc_eq = sc.TimeController(dt=eq_dt, initial_time=0.0,
                              final_time=eq_hours, time_unit="hour")
    tv = [0.0, tc_eq.t_final]
    bc = lithostatic_bcs(eq, names, tv, p_top)
    p_cavern = 10 * ut.MPa
    bc.add_boundary_condition(momBC.NeumannBC(
        names["cavern"], 2, rho_fluid, H_cavern,
        [p_cavern, p_cavern], tv, g=-9.81))
    eq.set_boundary_conditions(bc)

    out = sc.SaveFields(eq)
    out.set_output_folder(os.path.join(out_root, "equilibrium"))
    out.add_output_field("u", "Displacement (m)")
    out.add_output_field("p_elems", "Mean stress (Pa)")
    sc.Simulator_M(eq, tc_eq, [out], compute_elastic_response=True).run()

    # ---- stage 2: operation (cyclic cavern pressure) ------------------ #
    tc_op = sc.TimeController(dt=op_dt, initial_time=0.0,
                              final_time=op_hours, time_unit="hour")
    cycle_t = np.linspace(0.0, tc_op.t_final, 49)
    p_min, p_max = 6 * ut.MPa, 12 * ut.MPa
    cycle_p = p_min + 0.5 * (p_max - p_min) * (
        1 + np.sin(2 * np.pi * cycle_t / (24 * ut.hour)))

    bc2 = lithostatic_bcs(eq, names, list(cycle_t), p_top)
    bc2.add_boundary_condition(momBC.NeumannBC(
        names["cavern"], 2, rho_fluid, H_cavern,
        list(cycle_p), list(cycle_t), g=-9.81))
    eq.set_boundary_conditions(bc2)

    out2 = sc.SaveFields(eq)
    out2.set_output_folder(os.path.join(out_root, "operation"))
    out2.add_output_field("u", "Displacement (m)")
    out2.add_output_field("p_elems", "Mean stress (Pa)")
    out2.add_output_field("q_elems", "Von Mises (Pa)")
    sc.Simulator_M(eq, tc_op, [out2], compute_elastic_response=False).run()


if __name__ == "__main__":
    main()
