"""One episode of a cell on the plain reference: the configuration's warm
state worked out from its inputs, then the traffic's steps with the fields
of every kept save and the state at the end.

``reference(cfg, traffic, mesh_path, start_h, dtype, device, root)`` finds
``reference/<configuration>.py`` by the configuration's name; that module's
``prepare(model, mesh, cfg, start_h, dt_h, root)`` brings the model to the
episode's start and returns the loads as a function of time (seconds).
"""
from __future__ import annotations

import importlib

import torch

from .fem import Model
from .mesh import Mesh

HOUR = 3600.0


def kept_steps(steps, save_every):
    """The episode's steps (1-based) whose save call writes: the first call
    and every ``save_every``-th after it."""
    return [k for k in range(1, steps + 1) if (k - 1) % save_every == 0]


def reference(cfg, traffic, mesh_path, start_h, dtype=torch.float64,
              device="cpu", root=".", strict=True):
    """{"saves": {field: [array per kept save]}, "state": {key: array},
    "iterations": [per step], "points", "tets"} of the episode starting at
    ``start_h``, in the mesh file's node and element order."""
    mesh = Mesh(mesh_path)
    model = Model(mesh, cfg, dtype, device)
    module = importlib.import_module(f"{__package__}.{cfg['name']}")
    dt = float(traffic["dt_h"]) * HOUR
    loads = module.prepare(model, mesh, cfg, start_h, traffic["dt_h"], root,
                           strict)
    fp = cfg["fixed_point"]
    fields = [name for name, _ in traffic["fields"]]
    keep = set(kept_steps(traffic["steps"], traffic["save_every"]))
    saves = {name: [] for name in fields}
    iterations = []
    t = start_h * HOUR
    for k in range(1, traffic["steps"] + 1):
        t += dt
        ite, _ = model.step(loads(t), dt, fp["tol"], fp["maxiter"], strict)
        iterations.append(ite)
        if k in keep:
            for name in fields:
                saves[name].append(model.field(name).double().cpu().numpy())
    return {"saves": saves, "state": model.state(), "iterations": iterations,
            "points": mesh.points, "tets": mesh.tets}
