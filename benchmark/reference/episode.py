"""One episode of a cell on the plain reference: the configuration's warm
state worked out from its inputs, then the traffic's steps with the fields
of every kept save and the state at the end.

``reference(cfg, traffic, mesh_path, start_h, dtype, device, root)`` finds
``reference/<configuration>.py`` by the configuration's name; that module's
``prepare(model, mesh, cfg, start_h, dt_h, root)`` brings the model to the
episode's start and returns the loads as a function of time (seconds).

A configuration with "heat" is coupled (reference/heat.py), and its
episode follows ``Simulator_TM.run()`` and ``solve_tm_time_steps``: at the
start the element temperature and the temperature of zero thermal strain
both become the heat field's, the creep rates are worked out again and the
fields are saved once (the run's first save call); each step is the heat
step, then the fixed point at the new element temperature.  The heat field
is saved as "T" and its state as ``heat_T`` and ``heat_T_old``.
"""
from __future__ import annotations

import importlib

import torch

from .fem import Model
from .heat import Heat
from .mesh import Mesh

HOUR = 3600.0


def kept_steps(steps, save_every, initial=False):
    """The episode's steps whose save call writes, 0 standing for a save at
    the start.  Without ``initial`` the calls are the steps 1..``steps``
    (a resumed ``Simulator_M``), with it the start and those steps
    (``Simulator_TM``); a call writes when its index, from 0, is a multiple
    of ``save_every``."""
    first = 0 if initial else 1
    return [k for k in range(first, steps + 1)
            if (k - first) % save_every == 0]


def reference(cfg, traffic, mesh_path, start_h, dtype=torch.float64,
              device="cpu", root=".", strict=True):
    """{"saves": {field: [array per kept save]}, "state": {key: array},
    "iterations": [per step], "points", "tets"} of the episode starting at
    ``start_h``, in the mesh file's node and element order."""
    mesh = Mesh(mesh_path)
    model = Model(mesh, cfg, dtype, device)
    heat = Heat(mesh, cfg, dtype, device) if "heat" in cfg else None
    module = importlib.import_module(f"{__package__}.{cfg['name']}")
    dt = float(traffic["dt_h"]) * HOUR
    loads = module.prepare(model, mesh, cfg, start_h, traffic["dt_h"], root,
                           strict)
    fp = cfg["fixed_point"]
    fields = [name for name, _ in traffic["fields"]]
    keep = set(kept_steps(traffic["steps"], traffic["save_every"],
                          initial=heat is not None))
    saves = {name: [] for name in fields}

    def save():
        for name in fields:
            a = heat.T if heat is not None and name == "T" \
                else model.field(name)
            saves[name].append(a.double().cpu().numpy())

    if heat is not None:
        model.T = heat.elems()
        model.T0 = model.T.clone()
        model.initial_rates()
        if 0 in keep:
            save()
    iterations = []
    t = start_h * HOUR
    for k in range(1, traffic["steps"] + 1):
        t += dt
        if heat is not None:
            heat.step(t, dt)
            model.T = heat.elems()
        ite, _ = model.step(loads(t), dt, fp["tol"], fp["maxiter"], strict)
        iterations.append(ite)
        if k in keep:
            save()
    state = model.state()
    if heat is not None:
        T = heat.T.double().cpu().numpy()
        state.update(heat_T=T, heat_T_old=T.copy())
    return {"saves": saves, "state": state, "iterations": iterations,
            "points": mesh.points, "tets": mesh.tets}
