"""JSON-driven simulation builder (port of ``safeincave_tpu/config.py``).

Consumes the JAX package's input-file schema (grid and output paths,
``time_settings`` with theta and time_list, ``body_force``, per-region
``constitutive_model`` blocks, ``solver_settings`` {LU | KrylovSolver},
``simulation_settings`` {equilibrium, operation}, per-boundary
``boundary_conditions``) and runs the two-stage geostatic equilibrium ->
operation workflow.  Every device object is built on ``device``: the card
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import os

import torch

from ._device import default_device
from .bcs import MomentumBC as momBC
from .fem import LinearMomentum, SolverSettings
from .materials import (Material, Spring, Viscoelastic, DislocationCreep,
                        PressureSolutionCreep, MunsonDawsonCreep,
                        ViscoplasticDesai, MohrCoulombViscoplastic,
                        MatsuokaNakaiViscoplastic)
from .mesh import GridHandlerGMSH
from .output import SaveFields
from .simulators import Simulator_M
from .timecontrol import TimeController
from .utils import read_json


class Simulator_GUI:
    """Build grid, equation, material and BCs from an input dict and run
    equilibrium -> operation."""

    def __init__(self, input_file: dict, device=None):
        self.input_file = input_file
        self.device = torch.device(device) if device else default_device()
        self.output_folder = input_file["output"]["path"]
        self.build_grid()
        self.initialize_equation()
        self.build_solver()
        self.initialize_material()
        self.set_gravity()

    # ------------------------------------------------------------------ #
    def build_grid(self):
        grid_path = self.input_file["grid"]["path"]
        grid_name = self.input_file["grid"]["name"]
        self.grid = GridHandlerGMSH(grid_name, grid_path)

    def initialize_equation(self):
        theta = self.input_file["time_settings"]["theta"]
        self.mom_eq = LinearMomentum(self.grid, theta=theta,
                                     device=self.device)

    def build_solver(self):
        """Solver settings.  'LU' has no matrix-free analog; it maps to a
        tight-tolerance Krylov solve."""
        cfg = self.input_file["solver_settings"]
        if cfg["type"] == "LU":
            settings = SolverSettings(method="bicgstab", rtol=1e-14,
                                      max_it=5000)
        elif cfg["type"] == "KrylovSolver":
            method = "cg" if cfg.get("method") == "cg" else "bicgstab"
            settings = SolverSettings(
                method=method, rtol=cfg.get("relative_tolerance", 1e-12),
                max_it=cfg.get("maximum_iterations", 2000))
        else:
            raise ValueError(f"Solver type {cfg['type']} not supported.")
        self.mom_eq.set_solver(settings)

    def initialize_material(self):
        self.mat = Material(self.grid.n_elems, device=self.device)
        density = self.grid.get_parameter(
            self.input_file["body_force"]["density"])
        self.mat.set_density(density)
        elastic = self.input_file["constitutive_model"]["elastic"]
        for elem_name, blk in elastic.items():
            E = self.grid.get_parameter(blk["parameters"]["E"])
            nu = self.grid.get_parameter(blk["parameters"]["nu"])
            self.mat.add_to_elastic(Spring(E, nu, elem_name))
        self.mom_eq.set_material(self.mat)

    def set_gravity(self):
        g_vec = [0.0, 0.0, 0.0]
        i = self.input_file["body_force"]["direction"]
        self.g = self.input_file["body_force"]["gravity"]
        g_vec[i] = self.g
        self.mom_eq.build_body_force(g_vec)

    # ------------------------------------------------------------------ #
    def _get_param(self, blk, name):
        return self.grid.get_parameter(blk["parameters"][name])

    def _build_nonelastic(self, elem_name, blk):
        kind = blk["type"]
        dev = self.device
        if kind == "KelvinVoigt":
            return Viscoelastic(self._get_param(blk, "eta"),
                                self._get_param(blk, "E"),
                                self._get_param(blk, "nu"), elem_name,
                                device=dev)
        if kind == "DislocationCreep":
            elem = DislocationCreep(self._get_param(blk, "A"),
                                    self._get_param(blk, "Q"),
                                    self._get_param(blk, "n"), elem_name,
                                    device=dev)
            self._set_T(blk)
            return elem
        if kind == "ViscoplasticDesai":
            names = ["mu_1", "N_1", "a_1", "eta", "n", "beta_1", "beta",
                     "m", "gamma", "sigma_t", "alpha_0"]
            p = {n: self._get_param(blk, n) for n in names}
            return ViscoplasticDesai(p["mu_1"], p["N_1"], p["a_1"], p["eta"],
                                     p["n"], p["beta_1"], p["beta"], p["m"],
                                     p["gamma"], p["sigma_t"], p["alpha_0"],
                                     elem_name, device=dev)
        if kind == "PressureSolutionCreep":
            elem = PressureSolutionCreep(self._get_param(blk, "A"),
                                         self._get_param(blk, "d"),
                                         self._get_param(blk, "Q"), elem_name,
                                         device=dev)
            self._set_T(blk)
            return elem
        if kind == "MunsonDawsonCreep":
            names = ["A", "Q", "n", "K0", "c", "m", "alpha_w", "beta_w",
                     "delta", "mu"]
            elem = MunsonDawsonCreep(*[self._get_param(blk, n)
                                       for n in names], elem_name, device=dev)
            self._set_T(blk)
            return elem
        if kind in ("MohrCoulombViscoplastic", "MatsuokaNakaiViscoplastic"):
            names = ["mu_1", "N_1", "cohesion", "friction_angle",
                     "dilation_angle", "sigma_t"]
            cls = (MohrCoulombViscoplastic
                   if kind == "MohrCoulombViscoplastic"
                   else MatsuokaNakaiViscoplastic)
            return cls(*[self._get_param(blk, n) for n in names], elem_name,
                       device=dev)
        raise ValueError(f"Element type {kind} not supported.")

    def _set_T(self, blk):
        """Temperature-dependent elements carry their T in the block."""
        if "T" in blk["parameters"]:
            T = self._get_param(blk, "T")
            self.mom_eq.set_T0(T)
            self.mom_eq.set_T(T)

    def element_exist(self, elem_name: str) -> bool:
        return any(e.name == elem_name for e in self.mom_eq.mat.elems_ne)

    def _build_bcs(self, t_values, value_fn):
        bc = momBC.BcHandler(self.mom_eq)
        for b_name, blk in self.input_file["boundary_conditions"].items():
            values = value_fn(blk)
            if blk["type"] == "neumann":
                bc.add_boundary_condition(momBC.NeumannBC(
                    boundary_name=b_name,
                    direction=blk["direction"],
                    density=blk["density"],
                    ref_pos=blk["reference_position"],
                    values=values, time_values=t_values, g=self.g))
            elif blk["type"] == "dirichlet":
                bc.add_boundary_condition(momBC.DirichletBC(
                    boundary_name=b_name, component=blk["component"],
                    values=values, time_values=t_values))
            else:
                raise ValueError(f"Boundary condition type {blk['type']} "
                                 "not supported.")
        self.mom_eq.set_boundary_conditions(bc)

    # ------------------------------------------------------------------ #
    def run_equilibrium(self):
        """Geostatic equilibrium stage."""
        ne_cfg = self.input_file["constitutive_model"]["nonelastic"]
        for elem_name, blk in ne_cfg.items():
            if blk["active"] and blk.get("equilibrium"):
                self.mom_eq.mat.add_to_non_elastic(
                    self._build_nonelastic(elem_name, blk))

        dt = self.input_file["simulation_settings"]["equilibrium"]["dt_max"]
        tf = self.input_file["simulation_settings"]["equilibrium"]["ite_max"] * dt
        tc = TimeController(dt=dt, initial_time=0.0, final_time=tf,
                            time_unit="second")

        t_values = [0.0, tc.t_final]
        self._build_bcs(t_values,
                        lambda blk: [blk["values"][0]] * len(t_values))

        out = SaveFields(self.mom_eq)
        out.set_output_folder(os.path.join(self.output_folder, "equilibrium"))
        out.add_output_field("u", "Displacement (m)")
        out.add_output_field("p_elems", "Mean Stress (MPa)")
        Simulator_M(self.mom_eq, tc, [out],
                    compute_elastic_response=True).run()

    def run_operation(self):
        """Transient operation stage."""
        ne_cfg = self.input_file["constitutive_model"]["nonelastic"]
        for elem_name, blk in ne_cfg.items():
            if blk["active"] and not self.element_exist(elem_name):
                elem = self._build_nonelastic(elem_name, blk)
                if (blk["type"] == "ViscoplasticDesai"
                        and self.input_file["simulation_settings"]
                        ["operation"].get("hardening")):
                    elem.compute_initial_hardening(self.mom_eq.sig_v,
                                                   Fvp_0=0.0)
                self.mom_eq.mat.add_to_non_elastic(elem)

        t_values = list(self.input_file["time_settings"]["time_list"])
        dt = self.input_file["simulation_settings"]["operation"]["dt_max"]
        tc = TimeController(dt=dt, initial_time=0.0, final_time=t_values[-1],
                            time_unit="second")

        self._build_bcs(t_values, lambda blk: blk["values"])

        out = SaveFields(self.mom_eq)
        out.set_output_folder(os.path.join(self.output_folder, "operation"))
        out.add_output_field("u", "Displacement (m)")
        out.add_output_field("p_elems", "Mean Stress (MPa)")
        out.add_output_field("q_elems", "Von Mises Stress (MPa)")
        compute_elastic = not self.input_file["simulation_settings"][
            "equilibrium"]["active"]
        Simulator_M(self.mom_eq, tc, [out],
                    compute_elastic_response=compute_elastic).run()

    def run(self):
        if self.input_file["simulation_settings"]["equilibrium"]["active"]:
            self.run_equilibrium()
        self.run_operation()


def run_from_json(path: str, device=None) -> Simulator_GUI:
    """Run the input file at ``path``; returns the finished simulator."""
    sim = Simulator_GUI(read_json(path), device=device)
    sim.run()
    return sim
