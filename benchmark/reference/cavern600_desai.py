"""Reference side of the cavern600_desai configuration: the elastic
response to the cyclic pressure at t = 0, then the warm-up at the traffic's
dt up to the episode's start, every step a converged fixed point."""
from __future__ import annotations

import numpy as np
import torch

from .fem import neumann

HOUR = 3600.0


def pressure_schedule(loads):
    """(times s, pressures Pa): the sinusoid sampled every ``sample_h``."""
    step = loads["sample_h"] * HOUR
    t = np.arange(0.0, loads["samples"] * step, step)
    p = loads["mean_Pa"] + loads["amplitude_Pa"] * np.sin(
        2 * np.pi * t / (loads["period_h"] * HOUR))
    return t, p


def prepare(model, mesh, cfg, start_h, dt_h, root, strict=True):
    spec = cfg["loads"]
    faces = [f for f in spec["faces"] if f in mesh.boundary_names()]
    ts, ps = pressure_schedule(spec)

    def loads(t):
        f = neumann(mesh, faces, float(np.interp(t, ts, ps)))
        return torch.as_tensor(f, dtype=model.dtype, device=model.device)

    fp = cfg["fixed_point"]
    model.elastic(loads(0.0))
    model.initial_rates()
    dt = dt_h * HOUR
    for k in range(1, int(round(start_h / dt_h)) + 1):
        model.step(loads(k * dt), dt, fp["tol"], fp["maxiter"], strict)
    return loads
