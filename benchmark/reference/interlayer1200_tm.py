"""Reference side of the interlayer1200_tm configuration: the elastic
response at t = 0 to the overburden's constant pressure on Top and the
cavern's sinusoid, then the initial rates; no warm-up step, since episodes
start at t = 0, where the episode (reference/episode.py) starts the heat
equation as ``Simulator_TM`` starts a stage.  The regions, the
Mohr-Coulomb interlayers, the thermal strain and the heat equation come
from the configuration through the reference ``Model`` and ``Heat``."""
from __future__ import annotations

import numpy as np
import torch

from .cavern600_desai import pressure_schedule
from .fem import neumann


def prepare(model, mesh, cfg, start_h, dt_h, root, strict=True):
    if start_h:
        raise ValueError("interlayer1200_tm: episodes start at t = 0")
    names = mesh.boundary_names()
    top = cfg["overburden"]
    spec = cfg["loads"]
    over = neumann(mesh, [f for f in top["faces"] if f in names],
                   top["pressure_Pa"])
    walls = [f for f in spec["faces"] if f in names]
    ts, ps = pressure_schedule(spec)

    def loads(t):
        f = over + neumann(mesh, walls, float(np.interp(t, ts, ps)))
        return torch.as_tensor(f, dtype=model.dtype, device=model.device)

    model.elastic(loads(0.0))
    model.initial_rates()
    return loads
