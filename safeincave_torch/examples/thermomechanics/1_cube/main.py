"""Coupled thermo-mechanics on a cube: heating drives thermal strain + creep.

The port's twin of examples/thermomechanics/1_cube/main.py
(``Simulator_TM`` with one-way T -> momentum coupling via thermal strains
and Arrhenius creep).
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

import safeincave_torch as sc  # noqa: E402
import safeincave_torch.utils as ut  # noqa: E402

momBC = sc.MomentumBC
heatBC = sc.HeatBC


def main(device=None):
    grid = sc.GridBox(nx=4, ny=4, nz=4)
    n = grid.n_elems
    one = np.ones(n)

    # -- heat ----------------------------------------------------------- #
    eq_heat = sc.HeatDiffusion(grid, device=device)
    eq_heat.set_solver(sc.SolverSettings(method="cg", rtol=1e-12, max_it=1000))
    mat = sc.Material(n, device=device)
    mat.set_density(2200.0 * one)
    mat.set_specific_heat_capacity(850.0 * one)
    mat.set_thermal_conductivity(5.0 * one)
    mat.set_thermal_expansion(4.4e-5 * one)
    eq_heat.set_material(mat)
    eq_heat.set_initial_T(torch.full((grid.n_nodes,), 298.0,
                                     dtype=torch.float64,
                                     device=eq_heat.device))

    tc = sc.TimeController(dt=1.0, initial_time=0.0, final_time=24.0,
                           time_unit="hour")
    tv = [0.0, tc.t_final]
    bc_h = heatBC.BcHandler(eq_heat)
    bc_h.add_boundary_condition(heatBC.DirichletBC("TOP", [330., 330.], tv))
    eq_heat.set_boundary_conditions(bc_h)

    # -- momentum ------------------------------------------------------- #
    eq_mom = sc.LinearMomentum(grid, theta=0.5, device=device)
    eq_mom.set_solver(sc.SolverSettings(method="bicgstab", rtol=1e-12,
                                        max_it=2000))
    mat.add_to_elastic(sc.Spring(102e9 * one, 0.3 * one, "spring"))
    mat.add_to_thermoelastic(sc.Thermoelastic(4.4e-5 * one, device=device))
    mat.add_to_non_elastic(sc.DislocationCreep(1.9e-20 * one, 51600 * one,
                                               3.0 * one, "creep",
                                               device=device))
    eq_mom.set_material(mat)
    eq_mom.build_body_force([0.0, 0.0, 0.0])

    bc_m = momBC.BcHandler(eq_mom)
    bc_m.add_boundary_condition(momBC.DirichletBC("WEST", 0, [0., 0.], tv))
    bc_m.add_boundary_condition(momBC.DirichletBC("SOUTH", 1, [0., 0.], tv))
    bc_m.add_boundary_condition(momBC.DirichletBC("BOTTOM", 2, [0., 0.], tv))
    bc_m.add_boundary_condition(momBC.NeumannBC(
        "TOP", 2, 0.0, 0.0, [5 * ut.MPa, 5 * ut.MPa], tv, g=0.0))
    eq_mom.set_boundary_conditions(bc_m)

    out_m = sc.SaveFields(eq_mom)
    out_m.set_output_folder(os.path.join("output", "tm_cube", "mom"))
    out_m.add_output_field("u", "Displacement (m)")
    out_m.add_output_field("q_elems", "Von Mises (Pa)")
    out_h = sc.SaveFields(eq_heat)
    out_h.set_output_folder(os.path.join("output", "tm_cube", "heat"))
    out_h.add_output_field("T", "Temperature (K)")

    sc.Simulator_TM(eq_mom, eq_heat, tc, [out_m, out_h],
                    compute_elastic_response=True).run()


if __name__ == "__main__":
    main()
