"""Cavern cooling: heat diffusion with Robin (convective) cavern wall.

The port's twin of examples/thermal/2_cavern/main.py: geothermal initial
profile, fixed surface temperature, geothermal-gradient flux at the bottom,
insulated sides, and h=5 W/m2K convection to the stored gas on the cavern
wall, integrated with a parabolic (small-steps-early) schedule.

The faces are the reference mesh's ("Top", "Bottom", "East", ...); on the
repository's cavern_proxy_600, the fallback, they are upper case, so each
face is looked up by its name and then by the name in upper case.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "..", ".."))

import safeincave_torch as sc  # noqa: E402
import safeincave_torch.utils as ut  # noqa: E402
from safeincave_torch.utils import find_grid  # noqa: E402

heatBC = sc.HeatBC

GRID_DIR = find_grid("cavern_regular_600_3D", fallback="cavern_proxy_600")


def main(n_time_steps=100, final_time=5.0, time_unit="year",
         grid_dir=GRID_DIR, device=None):
    grid = sc.GridHandlerGMSH("geom", grid_dir, reorder="morton")
    output_folder = os.path.join("output", "case_0")

    t_control = sc.TimeControllerParabolic(
        n_time_steps=n_time_steps, initial_time=0, final_time=final_time,
        time_unit=time_unit)

    heat_eq = sc.HeatDiffusion(grid, device=device)
    heat_eq.set_solver(sc.SolverSettings(method="cg", rtol=1e-12,
                                         max_it=500))

    n = heat_eq.n_elems
    one = np.ones(n)
    mat = sc.Material(n, device=device)
    mat.set_density(2000.0 * one)
    mat.set_specific_heat_capacity(850.0 * one)
    mat.set_thermal_conductivity(7.0 * one)
    heat_eq.set_material(mat)

    time_values = [t_control.t_initial, t_control.t_final]
    nt = len(time_values)

    km = 1000.0
    dTdZ = 27 / km
    T_top = 273 + 20
    T_gas = 273 + 10
    h_conv = 5.0

    faces = set(grid.get_boundary_names())

    def face(name):
        return name if name in faces else name.upper()

    bc = heatBC.BcHandler(heat_eq)
    bc.add_boundary_condition(heatBC.DirichletBC(face("Top"), nt * [T_top],
                                                 time_values))
    bc.add_boundary_condition(heatBC.NeumannBC(face("Bottom"), nt * [dTdZ],
                                               time_values))
    for name in ("East", "West", "South", "North"):
        bc.add_boundary_condition(heatBC.NeumannBC(face(name), nt * [0.0],
                                                   time_values))
    bc.add_boundary_condition(heatBC.RobinBC("Cavern", nt * [T_gas], h_conv,
                                             time_values))
    heat_eq.set_boundary_conditions(bc)

    Lz = grid.points[:, 2].max()
    T0_field = ut.create_field_nodes(grid, lambda x, y, z:
                                     T_top - dTdZ * (z - Lz))
    heat_eq.set_initial_T(T0_field)

    output_heat = sc.SaveFields(heat_eq)
    output_heat.set_output_folder(output_folder)
    output_heat.add_output_field("T", "Temperature (K)")

    sim = sc.Simulator_T(heat_eq, t_control, [output_heat], True)
    sim.run()


if __name__ == "__main__":
    main()
