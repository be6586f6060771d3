"""Carry equation state across packages as numpy arrays.

``numpy_state`` reads the state of a momentum equation of either package,
and of a heat equation beside it (it only converts arrays with numpy, so it
needs no JAX import), and ``load_numpy_state`` places such a state on the
port's equations at their device and dtype.  Element arrays of a sharded
equation are read at the true element count (a port equation's gathered
from every rank of a multi-card run, so every rank makes the call).  Tests
use the pair to start both packages from the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from .fem.momentum import LinearMomentumBase
from .utils import to_numpy, unpad_elems

NODAL = ("u", "_u_last_step")
ELEMENT = ("sig_v", "eps_tot_v", "Temp", "T0")
FIELDS = NODAL + ELEMENT
THERMAL = ("density", "cp", "k", "alpha_th")


def numpy_state(eq, heat=None) -> dict:
    """{"u", "sig_v", "eps_tot_v", "_u_last_step" (if set), "Temp", "T0",
    "states", "params", "thermo", "thermal", "heat"}: fields, each inelastic
    element's state and parameters, each thermoelastic element's expansion
    coefficient, the material's thermal properties (those that are set) and,
    with ``heat``, its T and T_old.  ``density`` is an element array of the
    equation (``shard_equation`` pads it); the other thermal properties are
    read as they are set."""
    if isinstance(eq, LinearMomentumBase):
        def elem(x):
            return unpad_elems(eq, x)
    else:
        # the JAX package's element arrays are whole, padded to n_elems by
        # its shard_equation
        n_true = getattr(eq, "n_elems_orig", eq.n_elems)

        def elem(x):
            return to_numpy(x)[:n_true]

    d = {k: to_numpy(getattr(eq, k)) for k in NODAL
         if getattr(eq, k, None) is not None}
    d.update({k: elem(getattr(eq, k)) for k in ELEMENT})
    elems = eq.mat.elems_ne
    d["states"] = [{k: elem(v) for k, v in e.state.items()} for e in elems]
    d["params"] = [{k: elem(v) for k, v in e.params.items()} for e in elems]
    d["thermo"] = [elem(th.alpha) for th in getattr(eq.mat, "elems_th", [])]
    d["thermal"] = {k: (elem if k == "density" else to_numpy)(
        getattr(eq.mat, k)) for k in THERMAL if hasattr(eq.mat, k)}
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
