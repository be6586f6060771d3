"""Flagship coupled run: cavern + overburden, equilibrium -> TM operation.

The port's twin of examples/thermomechanics/2_cavern/main.py:

* two-region (Salt / Overburden) cavern mesh with per-region elastic, KV,
  dislocation + pressure-solution creep, and thermoelastic parameters;
* geothermal initial temperature profile;
* stage 1 (equilibrium): mechanics-only Simulator_M on a parabolic schedule,
  hydrostatic gas column on the cavern wall at 0.8 p_roof;
* stage 2 (operation): Simulator_TM with a Robin (h=5) convective cavern
  wall (reference main.py:269-274), geothermal-flux bottom, and a cyclic
  0.8 <-> 0.2 p_roof cavern-pressure schedule over 240 days
  (reference main.py:305-313), starting from the equilibrated state
  (compute_elastic_response=False, reference main.py:349).

The mesh is the reference's cavern_overburden_coarse (geom.msh and the
gmsh source geom.geo, whose layer thicknesses set the loads), from a
mounted copy of the reference's grids or the repository's ``grids/``.  The
repository does not hold it yet, so without a mounted copy the script
raises ``FileNotFoundError`` naming the grid.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

import safeincave_torch as sc  # noqa: E402
from safeincave_torch.utils import (GPa, MPa, day,  # noqa: E402
                                    REFERENCE_GRIDS, create_field_elems,
                                    create_field_nodes)

momBC = sc.MomentumBC
heatBC = sc.HeatBC
GRID = "cavern_overburden_coarse"


def find_mesh():
    """The folder holding the grid's geom.msh and geom.geo."""
    repo_grids = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "..", "..", "..", "..", "grids")
    for folder in (os.path.join(REFERENCE_GRIDS, GRID),
                   os.path.join(repo_grids, GRID)):
        if all(os.path.isfile(os.path.join(folder, f))
               for f in ("geom.msh", "geom.geo")):
            return folder
    raise FileNotFoundError(f"grid {GRID!r} (geom.msh and geom.geo) is "
                            f"neither mounted with the reference's grids "
                            f"nor in the repository's grids/")


def get_geometry_parameters(path_to_grid):
    """Parse layer thicknesses from the gmsh source (reference idiom)."""
    with open(os.path.join(path_to_grid, "geom.geo")) as f:
        data = f.readlines()
    ovb_thickness = float(data[10][len("ovb_thickness = "):-2])
    salt_thickness = float(data[11][len("salt_thickness = "):-2])
    hanging_wall = float(data[12][len("hanging_wall = "):-2])
    return ovb_thickness, salt_thickness, hanging_wall


def main(grid_dir=None, n_eq_steps=20, eq_days=10.0,
         op_days=240.0, op_dt_days=0.5, cycle_days=20.0, device=None):
    grid_dir = grid_dir or find_mesh()
    grid = sc.GridHandlerGMSH("geom", grid_dir, reorder="morton")
    output_folder = os.path.join("output", "case_1")

    ind_salt = grid.region_indices["Salt"]
    ind_ovb = grid.region_indices["Overburden"]

    mom_eq = sc.LinearMomentum(grid, theta=0.0, device=device)
    mom_eq.set_solver(sc.SolverSettings(method="bicgstab", rtol=1e-12,
                                        max_it=400))

    n = mom_eq.n_elems
    mat = sc.Material(n, device=device)

    gas_density = 0.082
    salt_density = 2200.0
    ovb_density = 2800.0
    rho = np.zeros(n)
    rho[ind_salt] = salt_density
    rho[ind_ovb] = ovb_density
    mat.set_density(rho)

    E0 = np.zeros(n)
    E0[ind_salt] = 102 * GPa
    E0[ind_ovb] = 180 * GPa
    nu0 = 0.3 * np.ones(n)
    mat.add_to_elastic(sc.Spring(E0, nu0, "spring"))

    eta = np.zeros(n)
    eta[ind_salt] = 105e11
    eta[ind_ovb] = 105e21           # effectively rigid dashpot in overburden
    E1 = 10 * GPa * np.ones(n)
    nu1 = 0.32 * np.ones(n)
    mat.add_to_non_elastic(sc.Viscoelastic(eta, E1, nu1, "kelvin",
                                           device=device))

    A = np.zeros(n)
    A[ind_salt] = 1.9e-20
    mat.add_to_non_elastic(sc.DislocationCreep(A, 51600 * np.ones(n),
                                               3.0 * np.ones(n), "ds_creep",
                                               device=device))

    A_ps = np.zeros(n)
    A_ps[ind_salt] = 1.29e-19
    mat.add_to_non_elastic(sc.PressureSolutionCreep(
        A_ps, 0.01 * np.ones(n), 13184 * np.ones(n), "ps_creep",
        device=device))

    alpha = np.zeros(n)
    alpha[ind_salt] = 44e-6
    mat.add_to_thermoelastic(sc.Thermoelastic(alpha, "thermo", device=device))

    mom_eq.set_material(mat)

    g = -9.81
    g_vec = [0.0, 0.0, g]
    mom_eq.build_body_force(g_vec)

    # geothermal initial temperature (reference main.py:112-118)
    km = 1000.0
    dTdZ = 27 / km
    T_top = 273 + 20
    Lz = grid.points[:, 2].max()
    T_field_fun = lambda x, y, z: T_top + dTdZ * (Lz - z)  # noqa: E731
    T0_field = create_field_elems(grid, T_field_fun)
    mom_eq.set_T0(T0_field)
    mom_eq.set_T(T0_field)

    # ---------------- stage 1: geostatic equilibrium -------------------- #
    tc_eq = sc.TimeControllerParabolic(n_time_steps=n_eq_steps,
                                       initial_time=0.0, final_time=eq_days,
                                       time_unit="day")

    ovb_thickness, salt_thickness, hanging_wall = \
        get_geometry_parameters(grid_dir)
    cavern_roof = ovb_thickness + hanging_wall
    p_roof = (salt_density * 9.81 * hanging_wall
              + ovb_density * 9.81 * ovb_thickness)

    def dirichlet_walls(bc, t_final):
        tv = [0.0, t_final]
        for name in ("West_salt", "West_ovb", "East_salt", "East_ovb"):
            bc.add_boundary_condition(momBC.DirichletBC(name, 0, [0., 0.],
                                                        tv))
        for name in ("South_salt", "South_ovb", "North_salt", "North_ovb"):
            bc.add_boundary_condition(momBC.DirichletBC(name, 1, [0., 0.],
                                                        tv))
        bc.add_boundary_condition(momBC.DirichletBC("Bottom", 2, [0., 0.],
                                                    tv))

    bc_eq = momBC.BcHandler(mom_eq)
    dirichlet_walls(bc_eq, tc_eq.t_final)
    bc_eq.add_boundary_condition(momBC.NeumannBC(
        "Top", 2, 0.0, 0.0, [0 * MPa, 0 * MPa], [0.0, tc_eq.t_final],
        g=g_vec[2]))
    bc_eq.add_boundary_condition(momBC.NeumannBC(
        "Cavern", 2, gas_density, cavern_roof,
        [0.8 * p_roof, 0.8 * p_roof], [0.0, tc_eq.t_final], g=g_vec[2]))
    mom_eq.set_boundary_conditions(bc_eq)

    out_eq = sc.SaveFields(mom_eq)
    out_eq.set_output_folder(os.path.join(output_folder, "equilibrium"))
    out_eq.add_output_field("u", "Displacement (m)")
    out_eq.add_output_field("p_elems", "Mean stress (Pa)")
    out_eq.add_output_field("q_elems", "Von Mises stress (Pa)")

    sc.Simulator_M(mom_eq, tc_eq, [out_eq], True).run()

    # ---------------- stage 2: TM operation ----------------------------- #
    tc_op = sc.TimeController(dt=op_dt_days, initial_time=0.0,
                              final_time=op_days, time_unit="day")

    heat_eq = sc.HeatDiffusion(grid, device=device)
    heat_eq.set_solver(sc.SolverSettings(method="cg", rtol=1e-12,
                                         max_it=400))
    mat.set_specific_heat_capacity(850 * np.ones(n))
    mat.set_thermal_conductivity(7 * np.ones(n))
    heat_eq.set_material(mat)
    heat_eq.set_initial_T(create_field_nodes(grid, T_field_fun))

    time_values = [tc_op.t_initial, tc_op.t_final]
    nt = len(time_values)
    bc_h = heatBC.BcHandler(heat_eq)
    bc_h.add_boundary_condition(heatBC.DirichletBC("Top", nt * [T_top],
                                                   time_values))
    bc_h.add_boundary_condition(heatBC.NeumannBC("Bottom", nt * [dTdZ],
                                                 time_values))
    for name in ("East_salt", "East_ovb", "West_salt", "West_ovb",
                 "South_salt", "South_ovb", "North_salt", "North_ovb"):
        bc_h.add_boundary_condition(heatBC.NeumannBC(name, nt * [0.0],
                                                     time_values))
    # convective gas-wall exchange (reference main.py:269-274)
    bc_h.add_boundary_condition(heatBC.RobinBC("Cavern", nt * [T_top], 5.0,
                                               time_values))
    heat_eq.set_boundary_conditions(bc_h)

    # cyclic cavern pressure 0.8 <-> 0.2 p_roof (reference main.py:305-313)
    n_cycles = max(1, int(round(op_days / cycle_days / 4)))
    p_values = n_cycles * [0.8 * p_roof, 0.8 * p_roof,
                           0.2 * p_roof, 0.2 * p_roof] + [0.8 * p_roof]
    t_values = [op_days / (4 * n_cycles) * day * i
                for i in range(4 * n_cycles + 1)]

    bc_op = momBC.BcHandler(mom_eq)
    dirichlet_walls(bc_op, tc_op.t_final)
    bc_op.add_boundary_condition(momBC.NeumannBC(
        "Top", 2, 0.0, 0.0, [0, 0], [0, tc_op.t_final], g=g_vec[2]))
    bc_op.add_boundary_condition(momBC.NeumannBC(
        "Cavern", 2, gas_density, cavern_roof, p_values, t_values,
        g=g_vec[2]))
    mom_eq.set_boundary_conditions(bc_op)

    out_op = sc.SaveFields(mom_eq)
    out_op.set_output_folder(os.path.join(output_folder, "operation"))
    out_op.add_output_field("u", "Displacement (m)")
    out_op.add_output_field("p_elems", "Mean stress (Pa)")
    out_op.add_output_field("q_elems", "Von Mises stress (Pa)")

    out_heat = sc.SaveFields(heat_eq)
    out_heat.set_output_folder(os.path.join(output_folder, "operation"))
    out_heat.add_output_field("T", "Temperature (K)")

    # operation starts from the equilibrated state (no elastic re-solve)
    sc.Simulator_TM(mom_eq, heat_eq, tc_op, [out_op, out_heat], False).run()


if __name__ == "__main__":
    main()
