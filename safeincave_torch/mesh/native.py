"""ctypes bindings of the C++ mesh-preprocessing library, with the numpy
versions beside them.

Port of ``safeincave_tpu/mesh/native.py``.  The source,
``native/mesh_preprocess.cpp`` at the repository root, is framework-neutral
and shared with the JAX package; this loader is the port's own.  It compiles
the source with the host ``g++`` at first use into the package's
``_build/`` directory (through ``_build.host_library``).  A build that
fails is reported once on stderr, and every entry point then runs its numpy
version; :func:`available` tells which of the two runs.
"""
from __future__ import annotations

import ctypes
import os
import sys

import numpy as np

SOURCE = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "native", "mesh_preprocess.cpp"))
_lib = None
_lib_tried = False


def _load():
    """The loaded library, or None after a failed build (tried once)."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        from .._build import host_library
        lib = host_library(SOURCE, "sicpre")
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.morton_order.argtypes = [f64p, ctypes.c_int64, i64p]
        lib.rcb_partition.argtypes = [f64p, ctypes.c_int64, ctypes.c_int32,
                                      i32p, i64p]
        lib.node_first_touch.argtypes = [i32p, ctypes.c_int64,
                                         ctypes.c_int64, i64p]
        lib.tet_adjacency.argtypes = [i32p, ctypes.c_int64, i64p]
        _lib = lib
    except Exception as exc:           # no compiler, no source, bad build
        detail = getattr(exc, "stderr", None) or exc
        print(f"[safeincave_torch] native mesh preprocessing unavailable "
              f"({detail}); using the numpy versions", file=sys.stderr)
        _lib = None
    return _lib


def available() -> bool:
    """Whether the C++ library built and loaded (else the numpy versions
    run)."""
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _use(native):
    """The library when ``native`` is None (and it built) or True (raises
    if it did not build); None when ``native`` is False."""
    if native is False:
        return None
    lib = _load()
    if native and lib is None:
        raise RuntimeError("the native mesh library did not build")
    return lib


# --------------------------------------------------------------------------- #
def morton_order(centroids: np.ndarray, native=None) -> np.ndarray:
    """Z-order locality permutation of elements (new_pos -> old_index).
    ``native``: None picks the library when it built, False the numpy
    version, True the library or an error."""
    centroids = np.ascontiguousarray(centroids, dtype=np.float64)
    n = centroids.shape[0]
    lib = _use(native)
    if lib is not None:
        out = np.empty(n, dtype=np.int64)
        lib.morton_order(_ptr(centroids, ctypes.c_double), n,
                         _ptr(out, ctypes.c_int64))
        return out
    # interleave 21-bit quantized coordinates
    lo = centroids.min(axis=0)
    span = centroids.max(axis=0) - lo
    ext = np.where(span > 0, span, 1.0)
    q = ((centroids - lo) / ext * 2097151.0).astype(np.uint64)

    def expand(v):
        v &= np.uint64(0x1fffff)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1f00000000ffff)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1f0000ff0000ff)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100f00f00f00f00f)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10c30c30c30c30c3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    code = (expand(q[:, 0]) | (expand(q[:, 1]) << np.uint64(1))
            | (expand(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable").astype(np.int64)


def rcb_partition(centroids: np.ndarray, nparts: int, native=None):
    """Recursive coordinate bisection -> (part id per element, ordering)."""
    centroids = np.ascontiguousarray(centroids, dtype=np.float64)
    n = centroids.shape[0]
    lib = _use(native)
    if lib is not None:
        parts = np.empty(n, dtype=np.int32)
        order = np.empty(n, dtype=np.int64)
        lib.rcb_partition(_ptr(centroids, ctypes.c_double), n, nparts,
                          _ptr(parts, ctypes.c_int32),
                          _ptr(order, ctypes.c_int64))
        return parts, order
    parts = np.zeros(n, dtype=np.int32)

    def recurse(ids, k, base):
        if k <= 1:
            parts[ids] = base
            return
        c = centroids[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        kl = k // 2
        split = len(ids) * kl // k
        ids_sorted = ids[np.argsort(c[:, axis], kind="stable")]
        recurse(ids_sorted[:split], kl, base)
        recurse(ids_sorted[split:], k - kl, base + kl)

    recurse(np.arange(n), nparts, 0)
    order = np.argsort(parts, kind="stable").astype(np.int64)
    return parts, order


def node_first_touch(conn: np.ndarray, n_nodes: int, native=None):
    """perm[old_node] = new_node, ordered by first appearance in conn;
    nodes no element touches follow in ascending order."""
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    lib = _use(native)
    if lib is not None:
        perm = np.empty(n_nodes, dtype=np.int64)
        lib.node_first_touch(_ptr(conn, ctypes.c_int32), conn.shape[0],
                             n_nodes, _ptr(perm, ctypes.c_int64))
        return perm
    nodes, where = np.unique(conn.reshape(-1), return_index=True)
    first = np.full(n_nodes, -1, dtype=np.int64)
    first[nodes[np.argsort(where, kind="stable")]] = np.arange(nodes.size)
    untouched = np.where(first < 0)[0]
    first[untouched] = np.arange(nodes.size, nodes.size + untouched.size)
    return first


def tet_adjacency(conn: np.ndarray, native=None) -> np.ndarray:
    """(E, 4) neighbour element across each face, -1 on boundary faces."""
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    n = conn.shape[0]
    lib = _use(native)
    if lib is not None:
        out = np.empty((n, 4), dtype=np.int64)
        lib.tet_adjacency(_ptr(conn, ctypes.c_int32), n,
                          _ptr(out, ctypes.c_int64))
        return out
    # sorted face triples: equal neighbours in key order share a face
    faces = conn[:, [[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]]]
    fs = np.sort(faces.reshape(-1, 3), axis=1).astype(np.int64)
    key = (fs[:, 0] << 42) | (fs[:, 1] << 21) | fs[:, 2]
    order = np.argsort(key, kind="stable")
    ks = key[order]
    i = np.where(ks[:-1] == ks[1:])[0]
    a, b = order[i], order[i + 1]
    out = np.full((n, 4), -1, dtype=np.int64)
    out[a // 4, a % 4] = b // 4
    out[b // 4, b % 4] = a // 4
    return out
