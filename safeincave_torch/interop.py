"""Carry equation state across packages as numpy arrays.

``numpy_state`` reads the state of a momentum equation of either package
(it only converts arrays with numpy, so it needs no JAX import), and
``load_numpy_state`` places such a state on a port equation at its device
and dtype.  Tests use the pair to start both packages from the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils import to_numpy as _np

FIELDS = ("u", "sig_v", "eps_tot_v", "_u_last_step")


def numpy_state(eq) -> dict:
    """{"u", "sig_v", "eps_tot_v", "_u_last_step" (if set), "states",
    "params"}: fields, and each inelastic element's state and parameters."""
    d = {k: _np(getattr(eq, k)) for k in FIELDS
         if getattr(eq, k, None) is not None}
    elems = eq.mat.elems_ne
    d["states"] = [{k: _np(v) for k, v in e.state.items()} for e in elems]
    d["params"] = [{k: _np(v) for k, v in e.params.items()} for e in elems]
    return d


def load_numpy_state(eq, d: dict) -> None:
    """Load a :func:`numpy_state` dict onto port equation ``eq``.

    Floating arrays become float64 on ``eq.device``; boolean flags stay
    boolean.  An optional ``"alpha_0"`` entry sets the Desai elements'
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
