"""Programmatic builder for the ``input_file.json`` schema (port of
``safeincave_tpu/app/builder.py``).

The reference edits this schema through a Tkinter GUI (its app/gsapp.py,
MyBoundaryCond.py, MyConstitutiveModel.py); here the same document is
built and edited through a fluent, validated Python API, which the terminal
editor (:mod:`safeincave_torch.app.editor`), the GUI and user scripts
drive.  The schema is the ``Simulator_GUI`` contract (reference
Simulators.py:856-911; consumed by safeincave_torch/config.py).
"""
from __future__ import annotations

import copy
import json
import os

VALID_BC_TYPES = ("dirichlet", "neumann")
VALID_SOLVER_TYPES = ("LU", "KrylovSolver")
VALID_ELEMENT_TYPES = ("KelvinVoigt", "DislocationCreep",
                       "ViscoplasticDesai", "PressureSolutionCreep",
                       "MunsonDawsonCreep", "MohrCoulombViscoplastic",
                       "MatsuokaNakaiViscoplastic")

ELEMENT_PARAMS = {
    "KelvinVoigt": ("eta", "E", "nu"),
    "DislocationCreep": ("A", "Q", "n", "T"),
    "ViscoplasticDesai": ("mu_1", "N_1", "a_1", "eta", "n", "beta_1",
                          "beta", "m", "gamma", "sigma_t", "alpha_0"),
    "PressureSolutionCreep": ("A", "d", "Q", "T"),
    "MunsonDawsonCreep": ("A", "Q", "n", "K0", "c", "m", "alpha_w",
                          "beta_w", "delta", "mu", "T"),
    "MohrCoulombViscoplastic": ("mu_1", "N_1", "cohesion",
                                "friction_angle", "dilation_angle",
                                "sigma_t"),
    "MatsuokaNakaiViscoplastic": ("mu_1", "N_1", "cohesion",
                                  "friction_angle", "dilation_angle",
                                  "sigma_t"),
}

_DEFAULT = {
    "grid": {"path": "", "name": "geom", "regions": {}, "boundaries": []},
    "output": {"path": "output/case_gui"},
    "solver_settings": {"type": "KrylovSolver", "method": "bicg",
                        "preconditioner": "asm",
                        "relative_tolerance": 1e-12},
    "simulation_settings": {
        "equilibrium": {"active": True, "dt_max": 7200.0,
                        "time_tol": 1e-4, "ite_max": 20},
        "operation": {"active": True, "dt_max": 3600.0, "n_skip": 1,
                      "hardening": False},
    },
    "body_force": {"gravity": 0.0, "density": 2000.0, "direction": 2},
    "time_settings": {"theta": 0.5, "time_list": [0.0, 86400.0]},
    "boundary_conditions": {},
    "constitutive_model": {"elastic": {}, "nonelastic": {}},
}


class InputFileBuilder:
    """Create / edit / validate / save an input_file.json document."""

    def __init__(self, data: dict | None = None):
        self.data = copy.deepcopy(_DEFAULT) if data is None \
            else copy.deepcopy(data)

    # -- loading --------------------------------------------------------- #
    @classmethod
    def load(cls, path: str) -> "InputFileBuilder":
        with open(path) as f:
            return cls(json.load(f))

    # -- sections -------------------------------------------------------- #
    def set_grid(self, path: str, name: str = "geom"):
        self.data["grid"]["path"] = path
        self.data["grid"]["name"] = name
        # discover regions/boundaries from the mesh when available
        msh = os.path.join(path, f"{name}.msh")
        if os.path.isfile(msh):
            from ..mesh.msh_io import read_msh
            data = read_msh(msh)
            self.data["grid"]["regions"] = {
                nm: tag for nm, (tag, dim) in data.field_data.items()
                if dim == 3}
            self.data["grid"]["boundaries"] = [
                nm for nm, (tag, dim) in data.field_data.items() if dim == 2]
        return self

    def set_output(self, path: str):
        self.data["output"]["path"] = path
        return self

    def set_solver(self, type="KrylovSolver", method="bicg",
                   preconditioner="asm", relative_tolerance=1e-12):
        if type not in VALID_SOLVER_TYPES:
            raise ValueError(f"solver type must be one of "
                             f"{VALID_SOLVER_TYPES}, got {type!r}")
        self.data["solver_settings"] = {
            "type": type, "method": method,
            "preconditioner": preconditioner,
            "relative_tolerance": relative_tolerance}
        return self

    def set_body_force(self, gravity=0.0, density=2000.0, direction=2):
        self.data["body_force"] = {"gravity": gravity, "density": density,
                                   "direction": direction}
        return self

    def set_time(self, time_list, theta=0.5):
        self.data["time_settings"] = {"theta": theta,
                                      "time_list": list(time_list)}
        return self

    def set_equilibrium(self, active=True, dt_max=7200.0, ite_max=20,
                        time_tol=1e-4):
        self.data["simulation_settings"]["equilibrium"] = {
            "active": active, "dt_max": dt_max, "time_tol": time_tol,
            "ite_max": ite_max}
        return self

    def set_operation(self, active=True, dt_max=3600.0, n_skip=1,
                      hardening=False):
        self.data["simulation_settings"]["operation"] = {
            "active": active, "dt_max": dt_max, "n_skip": n_skip,
            "hardening": hardening}
        return self

    # -- boundary conditions (MyBoundaryCond.py contract) ----------------- #
    def add_dirichlet(self, boundary: str, component: int, values):
        self.data["boundary_conditions"][boundary] = {
            "type": "dirichlet", "component": int(component),
            "values": list(values)}
        return self

    def add_neumann(self, boundary: str, direction: int, values,
                    density=0.0, reference_position=0.0):
        self.data["boundary_conditions"][boundary] = {
            "type": "neumann", "direction": int(direction),
            "density": density, "reference_position": reference_position,
            "values": list(values)}
        return self

    def remove_bc(self, boundary: str):
        self.data["boundary_conditions"].pop(boundary, None)
        return self

    def import_pressure_csv(self, boundary: str, csv_path: str,
                            direction=2, density=0.0,
                            reference_position=0.0):
        """CSV pressure import (gsapp.py:983 idiom): hourly MPa series to a
        Neumann schedule; also refreshes time_settings.time_list."""
        from ..schedules import read_pressure_csv
        p_mpa = read_pressure_csv(csv_path)
        t_vals = [3600.0 * i for i in range(len(p_mpa))]
        self.set_time(t_vals, theta=self.data["time_settings"]["theta"])
        return self.add_neumann(boundary, direction,
                                [float(p) * 1e6 for p in p_mpa],
                                density=density,
                                reference_position=reference_position)

    # -- constitutive model (MyConstitutiveModel.py contract) ------------- #
    def set_elastic(self, name: str, E, nu):
        self.data["constitutive_model"]["elastic"][name] = {
            "type": "Spring", "active": True,
            "parameters": {"E": E, "nu": nu}}
        return self

    def add_nonelastic(self, name: str, type: str, parameters: dict,
                       active=True, equilibrium=False):
        """Add an inelastic element block.

        Each parameter value may be a scalar (homogeneous), a
        ``{region_name: value}`` dict, or a per-element list — all three are
        expanded by ``grid.get_parameter`` at build time (reference
        Grid.py:538-579 idiom, e.g. the interlayer and salt parameter sets
        of the reference's examples/mechanics/nobian/Simulation/
        run_interlayer.py).
        """
        if type not in VALID_ELEMENT_TYPES:
            raise ValueError(f"element type must be one of "
                             f"{VALID_ELEMENT_TYPES}, got {type!r}")
        missing = [p for p in ELEMENT_PARAMS[type] if p not in parameters]
        if missing:
            raise ValueError(f"{type} missing parameters: {missing}")
        self.data["constitutive_model"]["nonelastic"][name] = {
            "type": type, "active": active, "equilibrium": equilibrium,
            "parameters": dict(parameters)}
        return self

    def remove_element(self, name: str):
        self.data["constitutive_model"]["nonelastic"].pop(name, None)
        self.data["constitutive_model"]["elastic"].pop(name, None)
        return self

    # -- validate / save / run ------------------------------------------- #
    def validate(self) -> list:
        """Return a list of problems (empty = valid for Simulator_GUI)."""
        d = self.data
        errs = []
        if not d["grid"]["path"]:
            errs.append("grid.path is not set")
        if not d["constitutive_model"]["elastic"]:
            errs.append("no elastic (Spring) element defined")
        for b, blk in d["boundary_conditions"].items():
            if blk["type"] not in VALID_BC_TYPES:
                errs.append(f"bc {b}: bad type {blk['type']}")
            n_t = len(d["time_settings"]["time_list"])
            if blk["type"] == "neumann" and len(blk["values"]) != n_t:
                errs.append(f"bc {b}: {len(blk['values'])} values vs "
                            f"{n_t} time points")
        tl = d["time_settings"]["time_list"]
        if sorted(tl) != list(tl):
            errs.append("time_settings.time_list is not increasing")
        for name, blk in d["constitutive_model"]["nonelastic"].items():
            if blk["type"] not in VALID_ELEMENT_TYPES:
                errs.append(f"element {name}: bad type {blk['type']}")
        return errs

    def save(self, path: str):
        errs = self.validate()
        if errs:
            raise ValueError("invalid input file:\n  " + "\n  ".join(errs))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.data, f, indent=2)
        return path

    def run(self, device=None):
        """Run the configured case in-process (Simulator_GUI path) on
        ``device`` (default: the card)."""
        from ..config import Simulator_GUI
        return Simulator_GUI(self.data, device=device).run()
