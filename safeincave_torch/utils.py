"""Tensor/Voigt utilities, unit constants and grid lookup.

Port of ``safeincave_tpu/utils.py``.  Voigt convention (identical to the
JAX package): order ``[xx, yy, zz, xy, xz, yz]`` with **tensorial** shear
storage, so a 6x6 operator contracted with a symmetric tensor is a plain
matvec and any factor-of-2 bookkeeping lives inside the operator.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Callable

import numpy as np
import torch

GPa = 1e9
MPa = 1e6
kPa = 1e3
minute = 60
hour = 60 * minute
day = 24 * hour
year = 365 * day

# Column scaling turning a single-entry derivative into the full symmetric
# tensor contraction: df/dS : dS = sum_k w[k] df/dS_voigt[k] dS_voigt[k].
VOIGT_WEIGHT = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0)
ISO6 = (1.0, 1.0, 1.0, 0.0, 0.0, 0.0)


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pad_elem_array(arr, n_pad: int, mode: str = "edge"):
    """``arr`` (a tensor or a numpy array) with ``n_pad`` rows appended on
    its leading (element) axis: copies of the last row (``"edge"``) or
    zeros (``"zero"``).  Edge padding keeps padded cells finite: a NaN in
    a padded cell would poison every sum over the cells, as 0 * NaN = NaN."""
    if n_pad == 0:
        return arr
    if isinstance(arr, torch.Tensor):
        tail = (arr[-1:].expand(n_pad, *arr.shape[1:]) if mode == "edge"
                else arr.new_zeros((n_pad, *arr.shape[1:])))
        return torch.cat([arr, tail])
    arr = np.asarray(arr)
    width = [(0, n_pad)] + [(0, 0)] * (arr.ndim - 1)
    if mode == "edge":
        return np.pad(arr, width, mode="edge")
    return np.pad(arr, width, constant_values=0)


def unpad_elems(eq, x) -> np.ndarray:
    """Element array ``x`` of a port equation, in its kernel's layout (on
    a sharded equation this rank's block of the padded elements), as a
    host numpy array over the true elements: gathered from every rank of a
    multi-card run, so every rank must make the call, and the element
    padding (parallel/sharding.py) sliced off."""
    kern = eq.kernel
    return to_numpy(kern.gather_elems(x))[:kern.n_elems_orig]


def is_main_process() -> bool:
    """Whether this process writes files: rank 0 of a ``torch.distributed``
    run, or a process outside one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def read_json(file_name: str) -> dict:
    """Read a JSON file into a dict."""
    with open(file_name, "r") as j_file:
        return json.load(j_file)


def save_json(data: dict, file_name: str) -> None:
    """Save a dict as indented JSON."""
    with open(file_name, "w") as f:
        json.dump(data, f, indent=4)


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype: torch.dtype, device: torch.device):
    return torch.tensor(values, dtype=dtype, device=device)


def voigt_weight(like: torch.Tensor) -> torch.Tensor:
    """``VOIGT_WEIGHT`` as a tensor on the device and in the dtype of
    ``like``, made once per (dtype, device): a fresh host-to-device copy
    per call would stall the stream.  Read-only."""
    return _const(VOIGT_WEIGHT, like.dtype, like.device)


def iso6(like: torch.Tensor) -> torch.Tensor:
    """The Voigt identity [1, 1, 1, 0, 0, 0], like :func:`voigt_weight`."""
    return _const(ISO6, like.dtype, like.device)


def tensor_to_voigt(e: torch.Tensor) -> torch.Tensor:
    """Symmetric (..., 3, 3) tensors -> (..., 6) tensorial Voigt."""
    return torch.stack([e[..., 0, 0], e[..., 1, 1], e[..., 2, 2],
                        e[..., 0, 1], e[..., 0, 2], e[..., 1, 2]], dim=-1)


def voigt_to_tensor(s: torch.Tensor) -> torch.Tensor:
    """(..., 6) tensorial Voigt -> symmetric (..., 3, 3) tensors."""
    xx, yy, zz, xy, xz, yz = (s[..., k] for k in range(6))
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def dotdot(C_voigt: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """sigma = C : eps for batched Voigt operators; ``eps`` is (..., 6)
    Voigt or (..., 3, 3) tensor and the result has the same layout."""
    if eps.shape[-1] == 6 and eps.dim() == C_voigt.dim() - 1:
        return torch.einsum("...ij,...j->...i", C_voigt, eps)
    sig_v = torch.einsum("...ij,...j->...i", C_voigt, tensor_to_voigt(eps))
    return voigt_to_tensor(sig_v)


def dev_voigt(s: torch.Tensor) -> torch.Tensor:
    """Deviatoric part of a (..., 6) Voigt tensor."""
    mean = (s[..., 0] + s[..., 1] + s[..., 2]) / 3.0
    out = s.clone()
    out[..., :3] -= mean[..., None]
    return out


def trace_voigt(s: torch.Tensor) -> torch.Tensor:
    return s[..., 0] + s[..., 1] + s[..., 2]


def norm_voigt(s: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of the symmetric tensor held as (..., 6) Voigt."""
    sq = s * s
    return torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2]
                      + 2.0 * (sq[..., 3] + sq[..., 4] + sq[..., 5]))


def von_mises_voigt(s: torch.Tensor) -> torch.Tensor:
    """Von Mises equivalent stress q = sqrt(3 J2) from (..., 6) Voigt."""
    xx, yy, zz, xy, xz, yz = (s[..., k] for k in range(6))
    return torch.sqrt(0.5 * ((xx - yy) ** 2 + (xx - zz) ** 2
                             + (yy - zz) ** 2
                             + 6.0 * (xy ** 2 + xz ** 2 + yz ** 2)))


Fn = Callable[[float, float, float], float]


def padded_bins(keys: np.ndarray, n_bins: int) -> np.ndarray:
    """(n_bins, K) int64 table of the positions of each bin's entries: row b
    lists, ascending, the k with ``keys[k] == b``; K is the largest count
    (at least 1) and short rows are padded with ``len(keys)``.  Summing a
    gather through this table is deterministic on CUDA, where ``index_add_``
    is atomic."""
    keys = np.asarray(keys, dtype=np.int64).reshape(-1)
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=n_bins)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(order.size) - starts[keys[order]]
    K = int(counts.max()) if counts.size else 0
    table = np.full((n_bins, max(K, 1)), keys.size, dtype=np.int64)
    table[keys[order], rank] = order
    return table


def _sample(xyz: np.ndarray, fun: Fn) -> np.ndarray:
    """``fun(x, y, z)`` at each row of ``xyz``, vectorized when ``fun``
    takes arrays, point by point otherwise; (n,) float64 on the host."""
    try:
        vals = fun(xyz[:, 0], xyz[:, 1], xyz[:, 2])
        return np.array(np.broadcast_to(np.asarray(vals, dtype=np.float64),
                                        (xyz.shape[0],)))
    except (TypeError, ValueError):    # a scalar-only fun given arrays
        return np.array([fun(x, y, z) for x, y, z in xyz], dtype=np.float64)


def create_field_nodes(grid, fun: Fn) -> np.ndarray:
    """Sample ``fun(x, y, z)`` at every mesh node (host float64, like
    ``Grid.get_parameter``; the equation's setters move it to its device)."""
    return _sample(np.asarray(grid.points), fun)


def create_field_elems(grid, fun: Fn) -> np.ndarray:
    """Sample ``fun`` at the tetrahedron centroids (host float64)."""
    return _sample(np.asarray(grid.centroids), fun)


# where the JAX package looks for a mounted checkout of the reference's
# full-resolution meshes; both packages resolve a name there first
REFERENCE_GRIDS = os.path.join(os.sep, "root", "reference", "grids")


def find_grid(name: str, fallback: str | None = None) -> str:
    """Directory of a grid fixture, found as the JAX package finds it.

    The mounted reference checkout (``REFERENCE_GRIDS/<name>``) comes first
    when it holds a ``geom.msh``, unless ``SAFEINCAVE_NO_REFERENCE=1``; then
    the repository's ``grids/`` (``fallback`` before ``name``); then any
    catalog cavern name (``cavern_<family>_<volume>_3D``) is synthesized
    into ``grids/`` by ``mesh/cavern_gen.py``.
    """
    no_ref = os.environ.get("SAFEINCAVE_NO_REFERENCE", "") == "1"
    ref = os.path.join(REFERENCE_GRIDS, name)
    if not no_ref and os.path.isfile(os.path.join(ref, "geom.msh")):
        return ref
    repo_grids = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "grids")
    for cand in ([fallback] if fallback else []) + [name]:
        d = os.path.join(repo_grids, cand)
        if os.path.isfile(os.path.join(d, "geom.msh")):
            return d
    from .mesh.cavern_gen import parse_grid_name, synthesize_grid
    if parse_grid_name(name) is not None:
        return synthesize_grid(name, repo_grids)
    raise FileNotFoundError(
        f"grid {name!r} not found (no mounted reference, no fixture under "
        f"{repo_grids}, and not a catalog shape)")
