"""Tkinter GUI for building and running ``input_file.json`` cases.

Port of ``safeincave_tpu/app/gsapp.py``, a rebuild of the reference GUI
suite:

* main window / tabs / console / run orchestration — the reference's
  app/gsapp.py:23-1027
* boundary-conditions tab (per-boundary type/direction/density/reference-
  position/values table, CSV import, live matplotlib schedule plot) —
  its app/MyBoundaryCond.py:11-442
* constitutive-model tab (add/edit/remove Spring / KelvinVoigt /
  DislocationCreep / ViscoplasticDesai blocks) —
  its app/MyConstitutiveModel.py:11-552

Unlike the reference, every piece of state lives in an
:class:`~safeincave_torch.app.builder.InputFileBuilder` (the widgets are a
thin view over it), so load/save/validate logic is shared with the
terminal editor and unit-testable without a display.  Runs are launched
through :class:`~safeincave_torch.app.simulator_runner.SimulatorRunner`
(subprocess + streamed console, on the card), same as the reference.

Entry points:
    python -m safeincave_torch.app.gsapp [case.json]
    >>> from safeincave_torch.app.gsapp import gui; gui()
"""
from __future__ import annotations

import json
import os
import queue
import sys

from .builder import (InputFileBuilder, ELEMENT_PARAMS, VALID_BC_TYPES,
                      VALID_ELEMENT_TYPES, VALID_SOLVER_TYPES)
from .simulator_runner import SimulatorRunner
from .script_runner import run_script

# Parameter sets shown by the elastic section of the constitutive tab
# (reference MyConstitutiveModel.py:80-230 hard-codes the same four types).
_ELASTIC_PARAMS = ("E", "nu")

_KSP_METHODS = ("cg", "bicg", "bicgstab", "gmres")
_PRECONDITIONERS = ("jacobi", "block_jacobi", "dense", "auto")


def _fmt(v):
    return json.dumps(v) if isinstance(v, (list, dict)) else str(v)


def _parse_number_list(text):
    """Parse whitespace/comma/newline-separated numbers (reference
    MyBoundaryCond.py:147-155 `is_number` row filtering)."""
    out = []
    for tok in text.replace(",", " ").split():
        out.append(float(tok))
    return out


class _FormSection:
    """A labeled grid of (label, Entry) rows bound to builder paths."""

    def __init__(self, tk, ttk, parent, rows, title=None):
        self.tk = tk
        frame = ttk.LabelFrame(parent, text=title) if title else \
            ttk.Frame(parent)
        frame.pack(fill="x", padx=8, pady=6)
        self.entries = {}
        for i, (label, initial) in enumerate(rows):
            ttk.Label(frame, text=label).grid(row=i, column=0, sticky="w",
                                              padx=4, pady=2)
            e = ttk.Entry(frame, width=48)
            e.insert(0, _fmt(initial))
            e.grid(row=i, column=1, sticky="we", padx=4, pady=2)
            self.entries[label] = e
        frame.columnconfigure(1, weight=1)
        self.frame = frame

    def get(self, label):
        return self.entries[label].get()

    def set(self, label, value):
        e = self.entries[label]
        e.delete(0, "end")
        e.insert(0, _fmt(value))


class BoundaryConditionsTab:
    """Per-boundary BC editor with schedule plot.

    View over ``builder.data["boundary_conditions"]`` reproducing the
    reference's JSONBoundaryApp behavior (MyBoundaryCond.py:11-442):
    boundary selector, type combobox, direction/component, density,
    reference position, editable value list, CSV import, matplotlib plot
    of the pressure/displacement schedule vs time_settings.time_list.
    """

    def __init__(self, tk, ttk, parent, app):
        self.tk, self.ttk, self.app = tk, ttk, app
        left = ttk.Frame(parent)
        left.pack(side="left", fill="y", padx=6, pady=6)
        right = ttk.Frame(parent)
        right.pack(side="left", fill="both", expand=True, padx=6, pady=6)

        ttk.Label(left, text="Boundary").pack(anchor="w")
        self.boundary_list = tk.Listbox(left, height=10, exportselection=0)
        self.boundary_list.pack(fill="y", expand=True)
        self.boundary_list.bind("<<ListboxSelect>>", self.load_boundary_data)

        form = ttk.Frame(right)
        form.pack(fill="x")

        def row(r, label, widget):
            ttk.Label(form, text=label).grid(row=r, column=0, sticky="w",
                                             padx=4, pady=2)
            widget.grid(row=r, column=1, sticky="we", padx=4, pady=2)
            return widget

        self.type_cb = row(0, "Type", ttk.Combobox(
            form, values=list(VALID_BC_TYPES), state="readonly"))
        self.type_cb.bind("<<ComboboxSelected>>", self.toggle_fields)
        self.dir_cb = row(1, "Direction / component", ttk.Combobox(
            form, values=["0 (x)", "1 (y)", "2 (z)"], state="readonly"))
        self.density_e = row(2, "Fluid density [kg/m3]", ttk.Entry(form))
        self.refpos_e = row(3, "Reference position [m]", ttk.Entry(form))
        form.columnconfigure(1, weight=1)

        ttk.Label(right, text="Values (one per time point)").pack(anchor="w")
        self.values_text = tk.Text(right, height=5, width=60)
        self.values_text.pack(fill="x")

        btns = ttk.Frame(right)
        btns.pack(fill="x", pady=4)
        ttk.Button(btns, text="Apply", command=self.apply).pack(side="left")
        ttk.Button(btns, text="Import CSV...",
                   command=self.browse_csv).pack(side="left", padx=4)
        ttk.Button(btns, text="Remove BC",
                   command=self.remove).pack(side="left", padx=4)
        self.status = ttk.Label(right, text="")
        self.status.pack(anchor="w")

        self.plot_frame = ttk.Frame(right)
        self.plot_frame.pack(fill="both", expand=True)
        self._canvas = None

    # -- data flow ------------------------------------------------------- #
    def set_boundary_list(self, names):
        """Reference MyBoundaryCond.py:126-145 SetBoundaryList."""
        self.boundary_list.delete(0, "end")
        for nm in names:
            self.boundary_list.insert("end", nm)

    def selected_boundary(self):
        sel = self.boundary_list.curselection()
        if not sel:
            return None
        return self.boundary_list.get(sel[0])

    def load_boundary_data(self, _event=None):
        """Populate the form from the builder (MyBoundaryCond.py:236-273)."""
        nm = self.selected_boundary()
        if nm is None:
            return
        blk = self.app.builder.data["boundary_conditions"].get(nm)
        if blk is None:
            blk = {"type": "dirichlet", "component": 0, "values": []}
        self.type_cb.set(blk["type"])
        comp = blk.get("direction", blk.get("component", 0))
        self.dir_cb.current(int(comp))
        self.density_e.delete(0, "end")
        self.density_e.insert(0, str(blk.get("density", 0.0)))
        self.refpos_e.delete(0, "end")
        self.refpos_e.insert(0, str(blk.get("reference_position", 0.0)))
        self.values_text.delete("1.0", "end")
        self.values_text.insert("1.0",
                                " ".join(str(v) for v in blk["values"]))
        self.toggle_fields()
        self.update_plot()

    def toggle_fields(self, _event=None):
        """Hide the hydrostatic-column fields for Dirichlet rows
        (MyBoundaryCond.py:373-404)."""
        neumann = self.type_cb.get() == "neumann"
        state = "normal" if neumann else "disabled"
        self.density_e.configure(state=state)
        self.refpos_e.configure(state=state)

    def apply(self):
        nm = self.selected_boundary()
        if nm is None:
            self.status.configure(text="select a boundary first")
            return
        try:
            values = _parse_number_list(self.values_text.get("1.0", "end"))
            comp = int(self.dir_cb.get().split()[0] or 0)
            if self.type_cb.get() == "neumann":
                self.app.builder.add_neumann(
                    nm, comp, values,
                    density=float(self.density_e.get() or 0.0),
                    reference_position=float(self.refpos_e.get() or 0.0))
            else:
                self.app.builder.add_dirichlet(nm, comp, values)
            self.status.configure(text=f"updated {nm}")
        except ValueError as exc:
            self.status.configure(text=f"error: {exc}")
            return
        self.update_plot()

    def remove(self):
        nm = self.selected_boundary()
        if nm:
            self.app.builder.remove_bc(nm)
            self.status.configure(text=f"removed {nm}")
            self.update_plot()

    def browse_csv(self):
        """CSV pressure import (MyBoundaryCond.py:157-186): hourly MPa
        series -> Neumann schedule + refreshed global time list."""
        from tkinter import filedialog
        nm = self.selected_boundary()
        if nm is None:
            self.status.configure(text="select a boundary first")
            return
        path = filedialog.askopenfilename(
            filetypes=[("CSV files", "*.csv"), ("All files", "*.*")])
        if not path:
            return
        self.app.builder.import_pressure_csv(
            nm, path,
            direction=int(self.dir_cb.get().split()[0] or 2),
            density=float(self.density_e.get() or 0.0),
            reference_position=float(self.refpos_e.get() or 0.0))
        self.app.refresh_time_tab()
        self.load_boundary_data()

    def update_plot(self):
        """Live schedule plot (MyBoundaryCond.py:333-354)."""
        nm = self.selected_boundary()
        blk = self.app.builder.data["boundary_conditions"].get(nm or "", {})
        values = blk.get("values", [])
        t = self.app.builder.data["time_settings"]["time_list"]
        try:
            from matplotlib.figure import Figure
            from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg
        except Exception:
            return
        if self._canvas is not None:
            self._canvas.get_tk_widget().destroy()
        fig = Figure(figsize=(5, 2.4), dpi=90)
        ax = fig.add_subplot(111)
        n = min(len(t), len(values))
        if n:
            ax.plot([ti / 3600.0 for ti in t[:n]], values[:n], "-o",
                    markersize=3)
        ax.set_xlabel("time [h]")
        ax.set_ylabel("prescribed value")
        ax.set_title(nm or "")
        fig.tight_layout()
        self._canvas = FigureCanvasTkAgg(fig, master=self.plot_frame)
        self._canvas.draw()
        self._canvas.get_tk_widget().pack(fill="both", expand=True)


class ConstitutiveModelTab:
    """Add/edit/remove constitutive blocks.

    View over ``builder.data["constitutive_model"]`` reproducing the
    reference's JSONConstitutiveApp (MyConstitutiveModel.py:11-552):
    a tree of existing elastic/nonelastic blocks, a type selector that
    swaps the visible parameter entries, add / keep-changes / remove.
    """

    def __init__(self, tk, ttk, parent, app):
        self.tk, self.ttk, self.app = tk, ttk, app

        left = ttk.Frame(parent)
        left.pack(side="left", fill="both", expand=True, padx=6, pady=6)
        right = ttk.Frame(parent)
        right.pack(side="left", fill="y", padx=6, pady=6)

        self.tree = ttk.Treeview(left, columns=("type", "active", "equil"),
                                 show="tree headings", height=12)
        self.tree.heading("type", text="Type")
        self.tree.heading("active", text="Active")
        self.tree.heading("equil", text="Equilibrium")
        self.tree.pack(fill="both", expand=True)
        self.tree.bind("<<TreeviewSelect>>", self.on_select)

        form = ttk.Frame(right)
        form.pack(fill="x")
        ttk.Label(form, text="Name").grid(row=0, column=0, sticky="w")
        self.name_e = ttk.Entry(form, width=28)
        self.name_e.grid(row=0, column=1, pady=2)
        ttk.Label(form, text="Type").grid(row=1, column=0, sticky="w")
        self.type_cb = ttk.Combobox(
            form, values=["Spring"] + list(VALID_ELEMENT_TYPES),
            state="readonly", width=26)
        self.type_cb.grid(row=1, column=1, pady=2)
        self.type_cb.bind("<<ComboboxSelected>>", self.type_select_change)
        self.active_var = tk.BooleanVar(value=True)
        self.equil_var = tk.BooleanVar(value=False)
        ttk.Checkbutton(form, text="active",
                        variable=self.active_var).grid(row=2, column=0)
        ttk.Checkbutton(form, text="equilibrium",
                        variable=self.equil_var).grid(row=2, column=1)

        self.param_frame = ttk.LabelFrame(right, text="Parameters")
        self.param_frame.pack(fill="x", pady=6)
        self.param_entries = {}

        btns = ttk.Frame(right)
        btns.pack(fill="x")
        ttk.Button(btns, text="Add / Keep changes",
                   command=self.add_or_update).pack(side="left")
        ttk.Button(btns, text="Remove",
                   command=self.remove).pack(side="left", padx=4)
        self.status = ttk.Label(right, text="")
        self.status.pack(anchor="w", pady=2)

        self.type_cb.set("Spring")
        self.type_select_change()

    # -- widget logic ------------------------------------------------------ #
    def _params_for(self, type_name):
        return _ELASTIC_PARAMS if type_name == "Spring" \
            else ELEMENT_PARAMS[type_name]

    def type_select_change(self, _event=None):
        """Swap visible parameter entries (MyConstitutiveModel.py:240-335)."""
        for w in self.param_frame.winfo_children():
            w.destroy()
        self.param_entries = {}
        for i, p in enumerate(self._params_for(self.type_cb.get())):
            self.ttk.Label(self.param_frame, text=p).grid(
                row=i, column=0, sticky="w", padx=4, pady=1)
            e = self.ttk.Entry(self.param_frame, width=20)
            e.grid(row=i, column=1, padx=4, pady=1)
            self.param_entries[p] = e

    def refresh_tree(self):
        """Re-list all blocks (MyConstitutiveModel.py:423-431)."""
        self.tree.delete(*self.tree.get_children())
        cm = self.app.builder.data["constitutive_model"]
        for name, blk in cm["elastic"].items():
            self.tree.insert("", "end", iid=f"elastic:{name}", text=name,
                             values=("Spring", True, ""))
        for name, blk in cm["nonelastic"].items():
            self.tree.insert("", "end", iid=f"nonelastic:{name}", text=name,
                             values=(blk["type"], blk.get("active", True),
                                     blk.get("equilibrium", False)))

    def on_select(self, _event=None):
        sel = self.tree.selection()
        if not sel:
            return
        category, name = sel[0].split(":", 1)
        blk = self.app.builder.data["constitutive_model"][category][name]
        self.name_e.delete(0, "end")
        self.name_e.insert(0, name)
        self.type_cb.set("Spring" if category == "elastic" else blk["type"])
        self.active_var.set(blk.get("active", True))
        self.equil_var.set(blk.get("equilibrium", False))
        self.type_select_change()
        for p, e in self.param_entries.items():
            e.delete(0, "end")
            e.insert(0, _fmt(blk["parameters"].get(p, "")))

    def add_or_update(self):
        """Commit the form to the builder
        (MyConstitutiveModel.py:337-421 Add_Keep_Changes)."""
        name = self.name_e.get().strip()
        if not name:
            self.status.configure(text="name required")
            return
        try:
            params = {p: json.loads(e.get()) if e.get() else 0.0
                      for p, e in self.param_entries.items()}
            t = self.type_cb.get()
            if t == "Spring":
                self.app.builder.set_elastic(name, params["E"], params["nu"])
            else:
                self.app.builder.add_nonelastic(
                    name, t, params, active=self.active_var.get(),
                    equilibrium=self.equil_var.get())
        except (ValueError, json.JSONDecodeError) as exc:
            self.status.configure(text=f"error: {exc}")
            return
        self.status.configure(text=f"saved {name}")
        self.refresh_tree()

    def remove(self):
        sel = self.tree.selection()
        if not sel:
            return
        _, name = sel[0].split(":", 1)
        self.app.builder.remove_element(name)
        self.refresh_tree()


class GsApp:
    """Main application window (reference gsapp.py:23-1027)."""

    def __init__(self, case_path: str | None = None, master=None):
        import tkinter as tk
        from tkinter import ttk, filedialog
        self.tk, self.ttk, self.filedialog = tk, ttk, filedialog

        self.builder = InputFileBuilder()
        self.case_path = case_path or "input_file.json"
        if case_path and os.path.isfile(case_path):
            self.builder = InputFileBuilder.load(case_path)

        self.root = master or tk.Tk()
        self.root.title("SafeInCave (PyTorch)")
        self.root.geometry("1000x780")

        self._console_q: queue.Queue[str] = queue.Queue()
        self.runner = SimulatorRunner(output_callback=self._console_q.put)

        self._build_widgets()
        self.populate_form()

    # -- construction ------------------------------------------------------ #
    def _build_widgets(self):
        tk, ttk = self.tk, self.ttk
        top = ttk.Frame(self.root)
        top.pack(fill="x", padx=8, pady=4)
        ttk.Button(top, text="Load JSON...",
                   command=self.load_from_file).pack(side="left")
        ttk.Button(top, text="Save JSON",
                   command=self.save_to_file).pack(side="left", padx=4)
        ttk.Button(top, text="Validate",
                   command=self.validate).pack(side="left", padx=4)
        ttk.Button(top, text="Run simulation",
                   command=self.run_simulation).pack(side="left", padx=12)
        ttk.Button(top, text="Stop",
                   command=self.runner.stop).pack(side="left")
        self.file_label = ttk.Label(top, text=self.case_path)
        self.file_label.pack(side="right")

        nb = ttk.Notebook(self.root)
        nb.pack(fill="both", expand=True, padx=8, pady=4)
        self.notebook = nb

        # Tab 1: Grid & Output (gsapp.py:586-630)
        tab1 = ttk.Frame(nb)
        nb.add(tab1, text="Grid & Output Settings")
        d = self.builder.data
        self.grid_form = _FormSection(tk, ttk, tab1, [
            ("Grid path", d["grid"]["path"]),
            ("Grid name", d["grid"]["name"]),
            ("Output path", d["output"]["path"]),
        ], title="Paths")
        btn = ttk.Button(tab1, text="Browse grid folder...",
                         command=self.select_grid_directory)
        btn.pack(anchor="w", padx=8)
        self.grid_info = ttk.Label(tab1, text="")
        self.grid_info.pack(anchor="w", padx=8, pady=4)

        # Tab 2: Solver (gsapp.py:632-641)
        tab2 = ttk.Frame(nb)
        nb.add(tab2, text="Solver Settings")
        s = d["solver_settings"]
        f = ttk.LabelFrame(tab2, text="Linear solver")
        f.pack(fill="x", padx=8, pady=6)
        ttk.Label(f, text="Type").grid(row=0, column=0, sticky="w", padx=4)
        self.solver_type_cb = ttk.Combobox(
            f, values=list(VALID_SOLVER_TYPES), state="readonly")
        self.solver_type_cb.set(s["type"])
        self.solver_type_cb.grid(row=0, column=1, padx=4, pady=2)
        ttk.Label(f, text="Method").grid(row=1, column=0, sticky="w", padx=4)
        self.solver_method_cb = ttk.Combobox(f, values=list(_KSP_METHODS),
                                             state="readonly")
        self.solver_method_cb.set(s.get("method", "bicg"))
        self.solver_method_cb.grid(row=1, column=1, padx=4, pady=2)
        ttk.Label(f, text="Preconditioner").grid(row=2, column=0, sticky="w",
                                                 padx=4)
        self.solver_pc_cb = ttk.Combobox(f, values=list(_PRECONDITIONERS),
                                         state="readonly")
        self.solver_pc_cb.set(s.get("preconditioner", "auto"))
        self.solver_pc_cb.grid(row=2, column=1, padx=4, pady=2)
        ttk.Label(f, text="Relative tolerance").grid(row=3, column=0,
                                                     sticky="w", padx=4)
        self.solver_rtol_e = ttk.Entry(f)
        self.solver_rtol_e.insert(0, str(s.get("relative_tolerance", 1e-12)))
        self.solver_rtol_e.grid(row=3, column=1, padx=4, pady=2)

        # Tab 3: Simulation settings (gsapp.py:741-843)
        tab3 = ttk.Frame(nb)
        nb.add(tab3, text="Simulation Settings")
        eqset = d["simulation_settings"]["equilibrium"]
        opset = d["simulation_settings"]["operation"]
        self.equil_form = _FormSection(tk, ttk, tab3, [
            ("active", eqset["active"]),
            ("dt_max [s]", eqset["dt_max"]),
            ("ite_max", eqset["ite_max"]),
        ], title="Equilibrium stage")
        self.oper_form = _FormSection(tk, ttk, tab3, [
            ("active", opset.get("active", True)),
            ("dt_max [s]", opset["dt_max"]),
            ("hardening", opset.get("hardening", False)),
        ], title="Operation stage")

        # Tab 4: Body force (gsapp.py:845-874)
        tab4 = ttk.Frame(nb)
        nb.add(tab4, text="Body Force")
        bf = d["body_force"]
        self.bf_form = _FormSection(tk, ttk, tab4, [
            ("gravity [m/s2]", bf["gravity"]),
            ("density [kg/m3]", bf["density"]),
            ("direction (0/1/2)", bf["direction"]),
        ], title="Body force")

        # Tab 5: Time settings (gsapp.py:876-912)
        tab5 = ttk.Frame(nb)
        nb.add(tab5, text="Time Settings")
        ts = d["time_settings"]
        f = ttk.LabelFrame(tab5, text="Time integration")
        f.pack(fill="x", padx=8, pady=6)
        ttk.Label(f, text="theta").grid(row=0, column=0, sticky="w", padx=4)
        self.theta_e = ttk.Entry(f, width=12)
        self.theta_e.insert(0, str(ts["theta"]))
        self.theta_e.grid(row=0, column=1, sticky="w", padx=4, pady=2)
        ttk.Label(tab5, text="time_list [s] (one per line or "
                             "space-separated)").pack(anchor="w", padx=8)
        self.time_list_text = tk.Text(tab5, height=12, width=40)
        self.time_list_text.pack(fill="both", expand=True, padx=8, pady=4)
        ttk.Button(tab5, text="Import CSV (hourly)...",
                   command=self.browse_csv_time).pack(anchor="w", padx=8)

        # Tab 6: Boundary conditions (MyBoundaryCond.py)
        tab6 = ttk.Frame(nb)
        nb.add(tab6, text="Boundary Conditions")
        self.bc_tab = BoundaryConditionsTab(tk, ttk, tab6, self)

        # Tab 7: Constitutive model (MyConstitutiveModel.py)
        tab7 = ttk.Frame(nb)
        nb.add(tab7, text="Constitutive model")
        self.cm_tab = ConstitutiveModelTab(tk, ttk, tab7, self)

        # Tab 8: Script runner (script_runner.py:9-110)
        tab8 = ttk.Frame(nb)
        nb.add(tab8, text="Script Runner")
        self.script_path_e = ttk.Entry(tab8)
        self.script_path_e.pack(fill="x", padx=8, pady=4)
        srow = ttk.Frame(tab8)
        srow.pack(anchor="w", padx=8)
        ttk.Button(srow, text="Browse...",
                   command=self.browse_script).pack(side="left")
        ttk.Button(srow, text="Run script",
                   command=self.run_user_script).pack(side="left", padx=4)

        # Console (gsapp.py:955-981)
        console_frame = ttk.LabelFrame(self.root, text="Output")
        console_frame.pack(fill="both", expand=True, padx=8, pady=4)
        self.console = tk.Text(console_frame, height=10,
                               state="disabled", bg="#111", fg="#ddd")
        self.console.pack(fill="both", expand=True)
        self.root.after(100, self._drain_console)

    # -- form <-> builder --------------------------------------------------- #
    def populate_form(self):
        """Refresh all widgets from the builder (gsapp.py:70-175)."""
        d = self.builder.data
        self.grid_form.set("Grid path", d["grid"]["path"])
        self.grid_form.set("Grid name", d["grid"]["name"])
        self.grid_form.set("Output path", d["output"]["path"])
        self._update_grid_info()
        self.refresh_time_tab()
        self.bc_tab.set_boundary_list(d["grid"].get("boundaries", []) or
                                      list(d["boundary_conditions"]))
        self.cm_tab.refresh_tree()

    def refresh_time_tab(self):
        ts = self.builder.data["time_settings"]
        self.theta_e.delete(0, "end")
        self.theta_e.insert(0, str(ts["theta"]))
        self.time_list_text.delete("1.0", "end")
        self.time_list_text.insert(
            "1.0", "\n".join(str(t) for t in ts["time_list"]))

    def save_data(self):
        """Collect every widget back into the builder (gsapp.py:362-558)."""
        b = self.builder
        b.set_grid(self.grid_form.get("Grid path"),
                   self.grid_form.get("Grid name"))
        b.set_output(self.grid_form.get("Output path"))
        b.set_solver(self.solver_type_cb.get(),
                     method=self.solver_method_cb.get(),
                     preconditioner=self.solver_pc_cb.get(),
                     relative_tolerance=float(self.solver_rtol_e.get()))
        b.set_equilibrium(
            active=json.loads(self.equil_form.get("active").lower()),
            dt_max=float(self.equil_form.get("dt_max [s]")),
            ite_max=int(self.equil_form.get("ite_max")))
        b.set_operation(
            active=json.loads(self.oper_form.get("active").lower()),
            dt_max=float(self.oper_form.get("dt_max [s]")),
            hardening=json.loads(self.oper_form.get("hardening").lower()))
        b.set_body_force(
            gravity=float(self.bf_form.get("gravity [m/s2]")),
            density=float(self.bf_form.get("density [kg/m3]")),
            direction=int(self.bf_form.get("direction (0/1/2)")))
        b.set_time(_parse_number_list(self.time_list_text.get("1.0", "end")),
                   theta=float(self.theta_e.get()))

    # -- actions ------------------------------------------------------------ #
    def _update_grid_info(self):
        d = self.builder.data["grid"]
        regions = list(d.get("regions", {}))
        bounds = d.get("boundaries", [])
        self.grid_info.configure(
            text=f"regions: {regions}\nboundaries: {bounds}")

    def select_grid_directory(self):
        path = self.filedialog.askdirectory()
        if not path:
            return
        self.grid_form.set("Grid path", path)
        self.builder.set_grid(path, self.grid_form.get("Grid name"))
        self._update_grid_info()
        self.bc_tab.set_boundary_list(
            self.builder.data["grid"].get("boundaries", []))

    def browse_csv_time(self):
        path = self.filedialog.askopenfilename(
            filetypes=[("CSV files", "*.csv"), ("All files", "*.*")])
        if not path:
            return
        from ..schedules import read_pressure_csv
        n = len(read_pressure_csv(path))
        self.builder.set_time([3600.0 * i for i in range(n)],
                              theta=float(self.theta_e.get()))
        self.refresh_time_tab()

    def browse_script(self):
        path = self.filedialog.askopenfilename(
            filetypes=[("Python files", "*.py"), ("All files", "*.*")])
        if path:
            self.script_path_e.delete(0, "end")
            self.script_path_e.insert(0, path)

    def run_user_script(self):
        path = self.script_path_e.get().strip()
        if path:
            run_script(path, output_callback=self._console_q.put)

    def load_from_file(self):
        path = self.filedialog.askopenfilename(
            filetypes=[("JSON files", "*.json"), ("All files", "*.*")])
        if not path:
            return
        self.builder = InputFileBuilder.load(path)
        self.case_path = path
        self.file_label.configure(text=path)
        self.populate_form()

    def save_to_file(self, path=None):
        self.save_data()
        path = path or self.case_path
        try:
            self.builder.save(path)
            self._console_q.put(f"saved {path}\n")
        except ValueError as exc:
            self._console_q.put(f"{exc}\n")
            return None
        return path

    def validate(self):
        self.save_data()
        errs = self.builder.validate()
        self._console_q.put(
            "input file is valid\n" if not errs
            else "problems:\n  " + "\n  ".join(errs) + "\n")

    def run_simulation(self):
        """Save then launch sim_cli in a subprocess (gsapp.py:965-981)."""
        path = self.save_to_file()
        if path is None:
            return
        self.runner.launch(path)

    # -- console pump -------------------------------------------------------- #
    def _drain_console(self):
        try:
            while True:
                line = self._console_q.get_nowait()
                self.console.configure(state="normal")
                self.console.insert("end", line)
                self.console.see("end")
                self.console.configure(state="disabled")
        except queue.Empty:
            pass
        self.root.after(100, self._drain_console)

    def mainloop(self):
        self.root.mainloop()


def gui(case_path: str | None = None):
    """Launch the GUI (reference gsapp.py:23 entry point)."""
    app = GsApp(case_path)
    app.mainloop()


if __name__ == "__main__":
    gui(sys.argv[1] if len(sys.argv) > 1 else None)
