"""Carry equation state across packages as numpy arrays.

``numpy_state`` reads the state of a momentum equation of either package,
and of a heat equation beside it (it only converts arrays with numpy, so it
needs no JAX import), and ``load_numpy_state`` places such a state on the
port's equations at their device and dtype.  Element arrays of a sharded
equation are read at the true element count.  Tests use the pair to start
both packages from the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils import to_numpy, unpad_elems

FIELDS = ("u", "sig_v", "eps_tot_v", "_u_last_step", "Temp", "T0")
THERMAL = ("density", "cp", "k", "alpha_th")


def numpy_state(eq, heat=None) -> dict:
    """{"u", "sig_v", "eps_tot_v", "_u_last_step" (if set), "Temp", "T0",
    "states", "params", "thermo", "thermal", "heat"}: fields, each inelastic
    element's state and parameters, each thermoelastic element's expansion
    coefficient, the material's thermal properties (those that are set) and,
    with ``heat``, its T and T_old."""
    def _np(x):
        return unpad_elems(eq, x)

    d = {k: _np(getattr(eq, k)) for k in FIELDS
         if getattr(eq, k, None) is not None}
    elems = eq.mat.elems_ne
    d["states"] = [{k: _np(v) for k, v in e.state.items()} for e in elems]
    d["params"] = [{k: _np(v) for k, v in e.params.items()} for e in elems]
    d["thermo"] = [_np(th.alpha) for th in getattr(eq.mat, "elems_th", [])]
    d["thermal"] = {k: _np(getattr(eq.mat, k)) for k in THERMAL
                    if hasattr(eq.mat, k)}
    if heat is not None:
        d["heat"] = {"T": to_numpy(heat.T), "T_old": to_numpy(heat.T_old)}
    return d


def load_numpy_state(eq, d: dict, heat=None) -> None:
    """Load a :func:`numpy_state` dict onto port equation ``eq`` (and heat
    equation ``heat``).

    Floating arrays become float64 on ``eq.device``; boolean flags stay
    boolean.  The thermal properties go to ``eq.mat`` (and from there to
    ``heat``).  An optional ``"alpha_0"`` entry sets the Desai elements'
    initial hardening parameter."""
    def to(a):
        a = np.array(a)    # a writable copy
        dtype = torch.bool if a.dtype == np.bool_ else torch.float64
        return torch.as_tensor(a, dtype=dtype, device=eq.device)

    for k in FIELDS:
        if k in d:
            setattr(eq, k, to(d[k]))
    elems = eq.mat.elems_ne
    for e, st in zip(elems, d.get("states", [])):
        e.state = {k: to(v) for k, v in st.items()}
    for e, p in zip(elems, d.get("params", [])):
        e.params = {k: to(v) for k, v in p.items()}
    if "alpha_0" in d:
        for e in elems:
            if "alpha_0" in e.params:
                e.params = dict(e.params, alpha_0=to(d["alpha_0"]))
    for th, alpha in zip(eq.mat.elems_th, d.get("thermo", [])):
        th.alpha = to(alpha)
    for k, v in d.get("thermal", {}).items():
        setattr(eq.mat, k, np.array(v, dtype=np.float64))
    if heat is not None:
        if d.get("thermal"):
            heat.initialize()
        if "heat" in d:
            heat.T, heat.T_old = to(d["heat"]["T"]), to(d["heat"]["T_old"])
