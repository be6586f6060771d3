"""Two-region cube: per-region elastic + Kelvin-Voigt parameters.

The port's twin of examples/mechanics/2_cube_regions/main.py: the cube is
split into OMEGA_A / OMEGA_B and every constitutive parameter is assigned
per region through ``grid.region_indices``; the two-region box generator
(``GridBoxRegions``) stands in for a gmsh fixture.
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


def main(device=None):
    grid = sc.GridBoxRegions(nx=4, ny=4, nz=4)
    output_folder = os.path.join("output", "case_0")

    t_control = sc.TimeController(dt=0.01, initial_time=0.0, final_time=0.1,
                                  time_unit="hour")

    mom_eq = sc.LinearMomentum(grid, theta=0.5, device=device)
    mom_eq.set_solver(sc.SolverSettings(method="cg", rtol=1e-12, max_it=500))

    n = mom_eq.n_elems
    mat = sc.Material(n, device=device)
    mat.set_density(np.zeros(n))

    omega_A = grid.region_indices["OMEGA_A"]
    omega_B = grid.region_indices["OMEGA_B"]

    E0 = np.zeros(n)
    nu0 = np.zeros(n)
    E0[omega_A] = 8 * ut.GPa
    E0[omega_B] = 10 * ut.GPa
    nu0[omega_A] = 0.2
    nu0[omega_B] = 0.3
    spring_0 = sc.Spring(E0, nu0, "spring")

    eta = np.zeros(n)
    E1 = np.zeros(n)
    nu1 = np.zeros(n)
    eta[omega_A] = 105e11
    eta[omega_B] = 38e11
    E1[omega_A] = 8 * ut.GPa
    E1[omega_B] = 5 * ut.GPa
    nu1[omega_A] = 0.35
    nu1[omega_B] = 0.28
    kelvin = sc.Viscoelastic(eta, E1, nu1, "kelvin", device=device)

    mat.add_to_elastic(spring_0)
    mat.add_to_non_elastic(kelvin)
    mom_eq.set_material(mat)

    g_vec = [0.0, 0.0, -9.81]
    mom_eq.build_body_force(g_vec)

    T0_field = torch.full((n,), 298.0, dtype=torch.float64,
                          device=mom_eq.device)
    mom_eq.set_T0(T0_field)
    mom_eq.set_T(T0_field)

    tv = [0.0, t_control.t_final]
    bc = momBC.BcHandler(mom_eq)
    bc.add_boundary_condition(momBC.DirichletBC("WEST", 0, [0., 0.], tv))
    bc.add_boundary_condition(momBC.DirichletBC("BOTTOM", 2, [0., 0.], tv))
    bc.add_boundary_condition(momBC.DirichletBC("SOUTH", 1, [0., 0.], tv))
    for name in ("EAST", "NORTH"):
        bc.add_boundary_condition(momBC.NeumannBC(
            name, 2, 0.0, 0.0, [5 * ut.MPa, 5 * ut.MPa], tv, g=g_vec[2]))
    bc.add_boundary_condition(momBC.NeumannBC(
        "TOP", 2, 0.0, 0.0, [8 * ut.MPa, 8 * ut.MPa], tv, g=g_vec[2]))
    mom_eq.set_boundary_conditions(bc)

    output_mom = sc.SaveFields(mom_eq)
    output_mom.set_output_folder(output_folder)
    output_mom.add_output_field("u", "Displacement (m)")
    output_mom.add_output_field("eps_tot", "Total strain (-)")
    output_mom.add_output_field("sig", "Stress (Pa)")
    output_mom.add_output_field("p_elems", "Mean stress (Pa)")
    output_mom.add_output_field("q_elems", "Von Mises stress (Pa)")

    sim = sc.Simulator_M(mom_eq, t_control, [output_mom], True)
    sim.run()


if __name__ == "__main__":
    main()
