"""Checkpoint / resume (port of ``safeincave_tpu/checkpoint.py``).

The full simulation state (displacement, stress and strain, every element's
state and parameters, temperatures, the time controller's position) is a
flat dict of arrays saved as one ``.npz`` with the JAX package's keys, so a
checkpoint written by either package loads into the other (the heat
equation's keys wait for the heat port).  The port adds
one key the JAX loader ignores: ``u_last_step``, the displacement the next
step's Krylov initial guess extrapolates from, without which a resumed run
starts its first solve from another guess and is not bitwise the straight
run.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .utils import to_numpy as _np


def save_checkpoint(path: str, eq, t_control=None,
                    extra: dict | None = None):
    """Serialize the full simulation state to ``path`` (.npz)."""
    data = {"u": _np(eq.u), "sig_v": _np(eq.sig_v),
            "eps_tot_v": _np(eq.eps_tot_v), "Temp": _np(eq.Temp),
            "T0": _np(eq.T0)}
    u_last = getattr(eq, "_u_last_step", None)
    if u_last is not None:
        data["u_last_step"] = _np(u_last)
    for idx, e in enumerate(eq.mat.elems_ne):
        for key, val in e.state.items():
            data[f"elem{idx}_{key}"] = _np(val)
        for key, val in e.params.items():
            data[f"elemparam{idx}_{key}"] = _np(val)
    if t_control is not None:
        data["tc_t"] = np.asarray(t_control.t)
        data["tc_step"] = np.asarray(t_control.step_counter)
    if extra:
        for k, v in extra.items():
            data[f"extra_{k}"] = _np(v)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **data)


def load_checkpoint(path: str, eq, t_control=None) -> dict:
    """Restore state saved by :func:`save_checkpoint` (of either package)
    onto a wired equation of the same mesh and material structure.

    Floating arrays become float64 tensors on ``eq.device``; boolean state
    stays boolean.  Without ``u_last_step`` (a JAX-package checkpoint) the
    next step's initial guess starts from ``u``.  Returns the ``extra_*``
    entries with the prefix stripped."""
    def to(a):
        a = np.array(a)    # a writable copy
        dtype = torch.bool if a.dtype == np.bool_ else torch.float64
        return torch.as_tensor(a, dtype=dtype, device=eq.device)

    with np.load(path) as z:
        for key in ("u", "sig_v", "eps_tot_v", "Temp", "T0"):
            setattr(eq, key, to(z[key]))
        eq._u_last_step = to(z["u_last_step"]) if "u_last_step" in z \
            else None
        for idx, e in enumerate(eq.mat.elems_ne):
            e.state = {k: to(z[f"elem{idx}_{k}"])
                       if f"elem{idx}_{k}" in z else v
                       for k, v in e.state.items()}
            e.params = {k: to(z[f"elemparam{idx}_{k}"])
                        if f"elemparam{idx}_{k}" in z else v
                        for k, v in e.params.items()}
        if t_control is not None and "tc_t" in z:
            t_control.t = float(z["tc_t"])
            t_control.step_counter = int(z["tc_step"])
        return {k[6:]: z[k] for k in z.files if k.startswith("extra_")}
