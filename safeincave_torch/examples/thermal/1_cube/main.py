"""Heat diffusion in a cube: Dirichlet bottom + Robin (convective) top.

The port's twin of examples/thermal/1_cube/main.py (``Simulator_T``).
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

import safeincave_torch as sc  # noqa: E402

heatBC = sc.HeatBC


def main(device=None):
    grid = sc.GridBox(nx=6, ny=6, nz=6)
    eq = sc.HeatDiffusion(grid, device=device)
    eq.set_solver(sc.SolverSettings(method="cg", rtol=1e-12, max_it=1000))

    n = grid.n_elems
    one = np.ones(n)
    mat = sc.Material(n, device=device)
    mat.set_density(2200.0 * one)
    mat.set_specific_heat_capacity(850.0 * one)
    mat.set_thermal_conductivity(5.0 * one)
    eq.set_material(mat)

    eq.set_initial_T(298.0 * np.ones(grid.n_nodes))

    tc = sc.TimeController(dt=0.5, initial_time=0.0, final_time=48.0,
                           time_unit="hour")
    tv = [0.0, tc.t_final]
    bc = heatBC.BcHandler(eq)
    bc.add_boundary_condition(heatBC.DirichletBC("BOTTOM", [330., 330.], tv))
    bc.add_boundary_condition(heatBC.RobinBC("TOP", [298., 298.], 25.0, tv))
    eq.set_boundary_conditions(bc)

    out = sc.SaveFields(eq)
    out.set_output_folder(os.path.join("output", "thermal_cube"))
    out.add_output_field("T", "Temperature (K)")

    sc.Simulator_T(eq, tc, [out]).run()


if __name__ == "__main__":
    main()
