"""Band (RCM) mesh reordering (port of the ``band`` branch of
safeincave_tpu/mesh/reorder.py, with ``band_order`` from
safeincave_tpu/fem/bandplan.py).

Morton and RCB orderings run through ``native/mesh_preprocess.cpp`` in the
JAX package; they are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np

from .grid import Grid

_NOT_PORTED = ("reorder method {!r} is not ported yet (Morton/RCB through "
               "native/mesh_preprocess.cpp is queued in ROADMAP.md); use "
               "'band'")


def band_order(conn: np.ndarray, n_nodes: int):
    """RCM node permutation + min-node element order.

    Returns (node_perm, elem_order) with ``node_perm[new] = old`` and
    ``elem_order[new] = old``.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    r = np.repeat(conn, conn.shape[1], axis=1).reshape(-1)
    c = np.tile(conn, (1, conn.shape[1])).reshape(-1)
    A = coo_matrix((np.ones_like(r, dtype=np.int8), (r, c)),
                   shape=(n_nodes, n_nodes)).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
    inv = np.empty(n_nodes, np.int64)
    inv[perm] = np.arange(n_nodes)
    conn_new = inv[conn]
    elem_order = np.argsort(conn_new.min(axis=1), kind="stable")
    return perm, elem_order


def _field_data(grid) -> dict:
    return {name: (tag, dim) for dim, names in grid.dolfin_tags.items()
            for name, tag in names.items()}


def reorder_arrays(points, tets, tet_tags, tris, tri_tags,
                   method: str = "band", nparts: int | None = None):
    """Band-reorder raw mesh arrays before Grid construction.

    Returns (points, tets, tet_tags, tris, tri_tags, parts=None)."""
    if method != "band":
        raise NotImplementedError(_NOT_PORTED.format(method))
    node_old, order = band_order(tets, points.shape[0])
    nperm = np.empty(points.shape[0], np.int64)
    nperm[node_old] = np.arange(points.shape[0])   # old -> new
    tets_new = nperm[tets[order]].astype(np.int32)
    points_new = np.empty_like(points)
    points_new[nperm] = points
    tris_new = nperm[tris].astype(np.int32) if tris.shape[0] else tris
    return points_new, tets_new, tet_tags[order], tris_new, tri_tags, None


def reordered_grid(grid, method: str = "band", nparts: int | None = None):
    """Return (new_grid, elem_order, node_perm) with
    ``elem_order[new_pos] = old_elem`` and ``node_perm[old] = new``."""
    if method != "band":
        raise NotImplementedError(_NOT_PORTED.format(method))
    node_old, order = band_order(grid.conn, grid.n_nodes)
    nperm = np.empty(grid.n_nodes, np.int64)
    nperm[node_old] = np.arange(grid.n_nodes)
    points_new = np.empty_like(grid.points)
    points_new[nperm] = grid.points
    conn_new = nperm[grid.conn[order]].astype(np.int32)
    tris_new = nperm[grid.tris].astype(np.int32)
    g2 = Grid(points_new, conn_new, grid.elem_tags[order], tris_new,
              grid.tri_tags, _field_data(grid))
    g2.reorder_method = method
    g2.elem_order = np.asarray(order)
    g2.node_perm = np.asarray(nperm)
    return g2, np.asarray(order), np.asarray(nperm)
