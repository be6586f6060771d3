"""Triaxial cube test: elastic + Kelvin-Voigt + dislocation creep + Desai.

The port's twin of examples/mechanics/1_triaxial/main.py: a unit salt cube
under confining pressure with a staged axial load schedule, using the
equation subclassing idiom (custom output fields set in run_after_solve).
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


class LinearMomentumMod(sc.LinearMomentum):
    """Expose per-mechanism strains + yield function as output fields."""

    def initialize(self):
        super().initialize()
        f64 = dict(dtype=torch.float64, device=self.device)
        self.eps_ve = torch.zeros((self.n_elems, 3, 3), **f64)
        self.eps_cr = torch.zeros((self.n_elems, 3, 3), **f64)
        self.eps_vp = torch.zeros((self.n_elems, 3, 3), **f64)
        self.Fvp = torch.zeros(self.n_elems, **f64)

    def run_after_solve(self):
        ve, cr, vp = self.mat.elems_ne
        self.eps_ve = ve.eps_ne_k
        self.eps_cr = cr.eps_ne_k
        self.eps_vp = vp.eps_ne_k
        self.Fvp = vp.state["Fvp"]


def main(final_time=24.0, dt=0.5, device=None):
    grid = sc.GridBox(nx=4, ny=4, nz=4)
    output_folder = os.path.join("output", "case_0")

    t_control = sc.TimeController(dt=dt, initial_time=0.0,
                                  final_time=final_time, time_unit="hour")

    mom_eq = LinearMomentumMod(grid, theta=0.5, device=device)
    mom_eq.set_solver(sc.SolverSettings(method="bicgstab", rtol=1e-12,
                                        max_it=2000))

    n = grid.n_elems
    one = np.ones(n)
    mat = sc.Material(n, device=device)
    mat.set_density(2000.0 * one)
    mat.add_to_elastic(sc.Spring(102e9 * one, 0.3 * one, "spring"))
    mat.add_to_non_elastic(sc.Viscoelastic(105e11 * one, 10e9 * one,
                                           0.32 * one, "kelvin",
                                           device=device))
    mat.add_to_non_elastic(sc.DislocationCreep(1.9e-20 * one, 51600 * one,
                                               3.0 * one, "creep",
                                               device=device))
    mat.add_to_non_elastic(sc.ViscoplasticDesai(
        mu_1=5.3665857009859815e-11 * one, N_1=3.1 * one,
        a_1=1.965018496922832e-05 * one, eta=0.8275682807874163 * one,
        n=3.0 * one, beta_1=0.0048 * one, beta=0.995 * one, m=-0.5 * one,
        gamma=0.095 * one, sigma_t=5.0 * one, alpha_0=0.0022 * one,
        name="desai", device=device))
    mom_eq.set_material(mat)

    mom_eq.build_body_force([0.0, 0.0, 0.0])
    mom_eq.set_T0(293.0 * one)
    mom_eq.set_T(293.0 * one)

    tf = t_control.t_final
    bc = momBC.BcHandler(mom_eq)
    bc.add_boundary_condition(momBC.DirichletBC("WEST", 0, [0., 0.], [0., tf]))
    bc.add_boundary_condition(momBC.DirichletBC("BOTTOM", 2, [0., 0.], [0., tf]))
    bc.add_boundary_condition(momBC.DirichletBC("SOUTH", 1, [0., 0.], [0., tf]))
    for name in ("EAST", "NORTH"):
        bc.add_boundary_condition(momBC.NeumannBC(
            name, 2, 0.0, 0.0, [4.0 * ut.MPa, 4.0 * ut.MPa], [0., tf], g=0.0))
    bc.add_boundary_condition(momBC.NeumannBC(
        "TOP", 2, 0.0, 0.0,
        [4.1 * ut.MPa, 16 * ut.MPa, 16 * ut.MPa, 6 * ut.MPa, 6 * ut.MPa],
        [0 * ut.hour, 2 * ut.hour, 14 * ut.hour, 16 * ut.hour, 24 * ut.hour],
        g=0.0))
    mom_eq.set_boundary_conditions(bc)

    output_mom = sc.SaveFields(mom_eq)
    output_mom.set_output_folder(output_folder)
    output_mom.add_output_field("u", "Displacement (m)")
    output_mom.add_output_field("eps_tot", "Total strain (-)")
    output_mom.add_output_field("eps_ve", "Viscoelastic strain (-)")
    output_mom.add_output_field("eps_cr", "Creep strain (-)")
    output_mom.add_output_field("eps_vp", "Viscoplastic strain (-)")
    output_mom.add_output_field("Fvp", "Yield function (-)")

    sim = sc.Simulator_M(mom_eq, t_control, [output_mom],
                         compute_elastic_response=True)
    sim.run()


if __name__ == "__main__":
    main()
