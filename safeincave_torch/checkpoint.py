"""Checkpoint / resume (port of ``safeincave_tpu/checkpoint.py``).

The full simulation state (displacement, stress and strain, every element's
state and parameters, temperatures, the time controller's position) is a
flat dict of arrays saved as one ``.npz`` with the JAX package's keys, so a
checkpoint written by either package loads into the other; a heat equation
adds ``heat_T`` and ``heat_T_old``.  The port adds one key the JAX loader
ignores: ``u_last_step``, the displacement the next step's Krylov initial
guess extrapolates from, without which a resumed run starts its first solve
from another guess and is not bitwise the straight run.

Element arrays of a sharded equation (parallel/sharding.py pads them to a
multiple of the part count) are saved at the true element count and padded
again on loading, so a checkpoint moves between sharded and unsharded
equations either way.  In a multi-card run every rank calls both: the save
gathers the ranks' element blocks and rank 0 writes, the load keeps each
rank's block.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import tracing
from .utils import (is_main_process, pad_elem_array, to_numpy as _np,
                    unpad_elems)


def save_checkpoint(path: str, eq, t_control=None, heat_eq=None,
                    extra: dict | None = None):
    """Serialize the full simulation state to ``path`` (.npz); in a
    multi-card run every rank calls it and rank 0 writes.  A
    ``checkpoint`` span of :mod:`~safeincave_torch.tracing`."""
    tracing.begin(tracing.CHECKPOINT)
    _save(path, eq, t_control, heat_eq, extra)
    tracing.end(tracing.CHECKPOINT)


def _save(path, eq, t_control, heat_eq, extra):
    def unpad(x):
        return unpad_elems(eq, x)

    data = {"u": _np(eq.u), "sig_v": unpad(eq.sig_v),
            "eps_tot_v": unpad(eq.eps_tot_v), "Temp": unpad(eq.Temp),
            "T0": unpad(eq.T0)}
    u_last = getattr(eq, "_u_last_step", None)
    if u_last is not None:
        data["u_last_step"] = _np(u_last)
    for idx, e in enumerate(eq.mat.elems_ne):
        for key, val in e.state.items():
            data[f"elem{idx}_{key}"] = unpad(val)
        for key, val in e.params.items():
            data[f"elemparam{idx}_{key}"] = unpad(val)
    if t_control is not None:
        data["tc_t"] = np.asarray(t_control.t)
        data["tc_step"] = np.asarray(t_control.step_counter)
    if heat_eq is not None:
        data["heat_T"] = _np(heat_eq.T)
        data["heat_T_old"] = _np(heat_eq.T_old)
    if extra:
        for k, v in extra.items():
            data[f"extra_{k}"] = _np(v)
    if not is_main_process():
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **data)


def load_checkpoint(path: str, eq, t_control=None, heat_eq=None) -> dict:
    """Restore state saved by :func:`save_checkpoint` (of either package)
    onto a wired equation (and heat equation) of the same mesh and material
    structure.

    Floating arrays become float64 tensors on ``eq.device``; boolean state
    stays boolean.  Element arrays are padded to a sharded equation's
    element count as ``shard_equation`` pads them (zero stress and strain,
    other arrays edge-replicated), and a rank keeps its block.  Without
    ``u_last_step`` (a JAX-package checkpoint) the next step's initial
    guess starts from ``u``.  Returns the ``extra_*`` entries with the
    prefix stripped."""
    kern = eq.kernel

    def to(a, mode=None):
        """A host array as a tensor; an element array (``mode`` given,
        saved at the true element count) padded as the equation's kernel
        pads, and its rank's block."""
        a = np.array(a)    # a writable copy
        if mode:
            a = kern.local(pad_elem_array(a, kern.n_pad, mode))
        dtype = torch.bool if a.dtype == np.bool_ else torch.float64
        return torch.as_tensor(a, dtype=dtype, device=eq.device)

    with np.load(path) as z:
        eq.u = to(z["u"])
        for key in ("sig_v", "eps_tot_v"):
            setattr(eq, key, to(z[key], "zero"))
        for key in ("Temp", "T0"):
            setattr(eq, key, to(z[key], "edge"))
        eq._u_last_step = to(z["u_last_step"]) if "u_last_step" in z \
            else None
        for idx, e in enumerate(eq.mat.elems_ne):
            e.state = {k: to(z[f"elem{idx}_{k}"], "edge")
                       if f"elem{idx}_{k}" in z else v
                       for k, v in e.state.items()}
            e.params = {k: to(z[f"elemparam{idx}_{k}"], "edge")
                        if f"elemparam{idx}_{k}" in z else v
                        for k, v in e.params.items()}
        if t_control is not None and "tc_t" in z:
            t_control.t = float(z["tc_t"])
            t_control.step_counter = int(z["tc_step"])
        if heat_eq is not None and "heat_T" in z:
            heat_eq.T = to(z["heat_T"])
            heat_eq.T_old = to(z["heat_T_old"])
        return {k[6:]: z[k] for k in z.files if k.startswith("extra_")}
