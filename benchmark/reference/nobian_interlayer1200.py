"""Reference side of the nobian_interlayer1200 configuration: the
equilibrium stage (elastic response, then dt = 5 d at a constant cavern
pressure), then the operation stage on the CSV year, rescaled into its
permit window, from day 0 at the traffic's dt up to the episode's start.

The CSV is read here with numpy (``;`` separated, decimal commas) and
turned into the stage's schedule as the nobian workflow does: hour for
hour, sampled at every step time."""
from __future__ import annotations

import os

import numpy as np
import torch

from .fem import neumann

HOUR = 3600.0
DAY = 24 * HOUR


def csv_pressures(path, column):
    """The hourly column ``column`` (MPa) of the operational CSV."""
    with open(path, encoding="utf-8") as f:
        rows = [line.strip().split(";") for line in f if line.strip()]
    col = [h.strip().lower() for h in rows[0]].index(column)
    return np.array([float(r[col].replace(",", ".")) for r in rows[1:]])


def operation_schedule(op, root, dt_h):
    """(times s, pressures Pa) of the operation stage, sampled every dt."""
    p = csv_pressures(os.path.join(root, op["csv"]), op["column"])
    lo, hi = op["rescale_MPa"]
    p = lo + (p - p.min()) / (p.max() - p.min()) * (hi - lo)
    if op["mode"] != "direct":
        raise ValueError("the reference follows the 'direct' mode only")
    hours = np.arange(0.0, op["days"] * 24 + 1e-12, 1.0)
    t_h, p_h = hours * HOUR, p[(hours % p.size).astype(int)]
    end = op["days"] * DAY
    dt = dt_h * HOUR
    grid = [k * dt for k in range(int(np.floor(end / dt)) + 1)]
    if abs(grid[-1] - end) > 1e-12:
        grid.append(end)
    grid = np.asarray(grid)
    return grid, np.interp(grid, t_h, p_h) * 1e6


def prepare(model, mesh, cfg, start_h, dt_h, root, strict=True):
    cav, top = cfg["cavern"], cfg["overburden"]
    z_ref = float(mesh.points[np.unique(mesh.tris[mesh.facets(cav["face"])]),
                              2].max())
    fp = cfg["fixed_point"]
    as_t = lambda f: torch.as_tensor(f, dtype=model.dtype,  # noqa: E731
                                     device=model.device)

    def loads_with(p_cavern):
        return as_t(neumann(mesh, [top["face"]], top["pressure_Pa"])
                    + neumann(mesh, [cav["face"]], p_cavern,
                              cav["fluid_density"], z_ref, cav["g"]))

    eq = cfg["equilibrium"]
    model.elastic(loads_with(eq["pressure_Pa"]))
    model.initial_rates()
    dt_eq = eq["dt_days"] * DAY
    for _ in range(int(round(eq["days"] / eq["dt_days"]))):
        model.step(loads_with(eq["pressure_Pa"]), dt_eq, fp["tol"],
                   fp["maxiter"], strict)

    ts, ps = operation_schedule(cfg["operation"], root, dt_h)

    def loads(t):
        return loads_with(float(np.interp(t, ts, ps)))

    model.initial_rates()
    dt = dt_h * HOUR
    for k in range(1, int(round(start_h / dt_h)) + 1):
        model.step(loads(k * dt), dt, fp["tol"], fp["maxiter"], strict)
    return loads
