"""Mesh reordering for memory locality and spatial partitioning (port of
safeincave_tpu/mesh/reorder.py, with ``band_order`` from
safeincave_tpu/fem/bandplan.py).

* ``morton``: Z-order curve over the element centroids.
* ``rcb``: recursive coordinate bisection into ``nparts`` spatially compact
  blocks of equal size; the grid keeps each element's block in
  ``elem_parts``.
* ``band``: reverse Cuthill-McKee node order and elements sorted by their
  smallest node, the layout the CUDA band kernel is selected for.

Morton and RCB renumber the nodes by first touch in the new element order
(``mesh/native.py``); ``band`` dictates the node order itself.  A Morton- or
RCB-ordered grid reaches no hand-written kernel: ``select_backend``
(fem/momentum.py) returns None for it, as the JAX package's accelerator
selection does, so its stiffness action is the cumsum operator unless
``enable_blockell_matvec`` is called.
"""
from __future__ import annotations

import numpy as np

from .grid import Grid
from .native import morton_order, node_first_touch, rcb_partition


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


def _orders(method, conn, n_nodes, centroids, nparts):
    """(elem_order, node_perm, parts): ``elem_order[new] = old``,
    ``node_perm[old] = new``, ``parts`` the RCB block of each element in
    the new order (None for the other methods)."""
    parts = None
    if method == "band":
        node_old, order = band_order(conn, n_nodes)
        nperm = np.empty(n_nodes, np.int64)
        nperm[node_old] = np.arange(n_nodes)
        return order, nperm, parts
    if method == "rcb":
        if not nparts or nparts < 1:
            raise ValueError("rcb reordering needs nparts >= 1")
        parts, order = rcb_partition(centroids, nparts)
        parts = parts[order]
    elif method == "morton":
        order = morton_order(centroids)
    else:
        raise ValueError(f"unknown reorder method {method!r}")
    return order, node_first_touch(conn[order], n_nodes), parts


def _field_data(grid) -> dict:
    return {name: (tag, dim) for dim, names in grid.dolfin_tags.items()
            for name, tag in names.items()}


def reorder_arrays(points, tets, tet_tags, tris, tri_tags,
                   method: str = "morton", nparts: int | None = None):
    """Reorder raw mesh arrays before Grid construction.

    Returns (points, tets, tet_tags, tris, tri_tags, parts): elements in
    the order of ``method``, nodes renumbered to match, ``parts`` the
    per-element RCB block (None otherwise)."""
    order, nperm, parts = _orders(method, tets, points.shape[0],
                                  points[tets].mean(axis=1), nparts)
    tets_new = nperm[tets[order]].astype(np.int32)
    points_new = np.empty_like(points)
    points_new[nperm] = points
    tris_new = nperm[tris].astype(np.int32) if tris.shape[0] else tris
    return points_new, tets_new, tet_tags[order], tris_new, tri_tags, parts


def reordered_grid(grid, method: str = "morton", nparts: int | None = None):
    """Return (new_grid, elem_order, node_perm) with
    ``elem_order[new_pos] = old_elem`` and ``node_perm[old] = new``:
    element fields of the new grid are ``field[elem_order]``, nodal ones
    ``new[node_perm] = old``."""
    order, nperm, parts = _orders(method, grid.conn, grid.n_nodes,
                                  grid.centroids, nparts)
    points_new = np.empty_like(grid.points)
    points_new[nperm] = grid.points
    conn_new = nperm[grid.conn[order]].astype(np.int32)
    tris_new = nperm[grid.tris].astype(np.int32)
    g2 = Grid(points_new, conn_new, grid.elem_tags[order], tris_new,
              grid.tri_tags, _field_data(grid))
    g2.reorder_method = method
    if parts is not None:
        g2.elem_parts = parts
    g2.elem_order = np.asarray(order)
    g2.node_perm = np.asarray(nperm)
    return g2, np.asarray(order), np.asarray(nperm)
