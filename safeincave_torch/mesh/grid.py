"""Grid: tags, regions, boundaries and vectorized geometry (host numpy).

Port of ``safeincave_tpu/mesh/grid.py``.  Geometry stays on the host: the
equation objects move what they need to their device.  ``_tet_geometry`` and
``_facet_geometry`` keep the JAX package's exact term order, so on the CPU
both packages produce bitwise-identical geometry.  The node<->element
smoother runs on the device of the field it is given.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .msh_io import read_msh, MshData


def _tet_geometry(points: np.ndarray, conn: np.ndarray):
    """Volumes, centroids and P1 shape-function gradients (E, 4, 3)."""
    p = points[conn]                       # (E, 4, 3)
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    e3 = p[:, 3] - p[:, 0]
    # Jacobian J columns are the edge vectors; det = 6 * signed volume
    det = (e1 * np.cross(e2, e3)).sum(axis=1)
    volumes = np.abs(det) / 6.0
    # inverse transpose of J via cross products: rows of J^{-1}
    c1 = np.cross(e2, e3)
    c2 = np.cross(e3, e1)
    c3 = np.cross(e1, e2)
    inv_det = 1.0 / det
    g1 = c1 * inv_det[:, None]
    g2 = c2 * inv_det[:, None]
    g3 = c3 * inv_det[:, None]
    g0 = -(g1 + g2 + g3)
    grad_N = np.stack([g0, g1, g2, g3], axis=1)
    centroids = p.mean(axis=1)
    return volumes, centroids, grad_N


def _facet_geometry(points, tris, tets, tet_centroids):
    """Areas, outward unit normals and owner tets of boundary triangles
    (outward is fixed by the owning tetrahedron)."""
    faces = tets[:, [[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]]]  # (E,4,3)
    faces_flat = np.sort(faces.reshape(-1, 3), axis=1)
    order = np.lexsort(faces_flat.T[::-1])
    faces_sorted = faces_flat[order]
    owner_sorted = np.repeat(np.arange(tets.shape[0]), 4)[order]

    tris_sorted_nodes = np.sort(tris, axis=1)
    idx = np.searchsorted(
        faces_sorted.view([('', faces_sorted.dtype)] * 3).ravel(),
        tris_sorted_nodes.view([('', tris_sorted_nodes.dtype)] * 3).ravel())
    idx = np.clip(idx, 0, faces_sorted.shape[0] - 1)
    matched = (faces_sorted[idx] == tris_sorted_nodes).all(axis=1)
    if not matched.all():
        raise ValueError("boundary triangle without owning tetrahedron")
    owners = owner_sorted[idx]

    a = points[tris[:, 0]]
    b = points[tris[:, 1]]
    c = points[tris[:, 2]]
    nvec = 0.5 * np.cross(b - a, c - a)    # area-weighted normal
    areas = np.linalg.norm(nvec, axis=1)
    normals = nvec / areas[:, None]
    face_cent = (a + b + c) / 3.0
    outward = ((face_cent - tet_centroids[owners]) * normals).sum(axis=1)
    normals = np.where(outward[:, None] >= 0, normals, -normals)
    return areas, normals, owners


class Grid:
    """Core mesh container + geometry, built from raw arrays."""

    def __init__(self, points, tets, tet_tags, tris, tri_tags, field_data):
        self.points = np.asarray(points, dtype=np.float64)
        self.conn = np.asarray(tets, dtype=np.int32)
        self.elem_tags = np.asarray(tet_tags, dtype=np.int32)
        self.tris = np.asarray(tris, dtype=np.int32)
        self.tri_tags = np.asarray(tri_tags, dtype=np.int32)

        self.n_nodes = self.points.shape[0]
        self.n_elems = self.conn.shape[0]
        self.domain_dim = 3
        self.boundary_dim = 2
        # locality ordering applied to this grid ("band" or None); the
        # momentum equation selects its f32 operator from it
        self.reorder_method: str | None = getattr(self, "reorder_method",
                                                  None)

        # gmsh physical-name table: {dim: {name: tag}}
        self.dolfin_tags = {1: {}, 2: {}, 3: {}}
        for name, (tag, dim) in field_data.items():
            if dim in self.dolfin_tags:
                self.dolfin_tags[dim][name] = tag
        self.tags = self.dolfin_tags

        mins = self.points.min(axis=0)
        maxs = self.points.max(axis=0)
        self.Lx, self.Ly, self.Lz = (maxs - mins).tolist()

        self.region_names = self.get_subdomain_names()
        self.n_regions = len(self.region_names)
        self.region_indices = {
            name: np.where(self.elem_tags == self.dolfin_tags[3][name])[0]
            for name in self.region_names}
        self.boundary_tags = {
            name: np.where(self.tri_tags == self.dolfin_tags[2][name])[0]
            for name in self.get_boundary_names()}

        self.volumes, self.centroids, self.grad_N = _tet_geometry(
            self.points, self.conn)
        if self.tris.shape[0]:
            self.tri_areas, self.tri_normals, self.tri_owners = \
                _facet_geometry(self.points, self.tris, self.conn,
                                self.centroids)
        else:
            self.tri_areas = np.zeros(0)
            self.tri_normals = np.zeros((0, 3))
            self.tri_owners = np.zeros(0, dtype=np.int64)
        self._build_smoother()

    # -- node <-> element smoothing ---------------------------------------- #
    def _build_smoother(self):
        """Volume-weighted element->node averaging as flat (node, element,
        weight) arrays over the 4E element corners, in the JAX package's
        order, and their node-major padded layout: row n of
        ``(elem_of, w_of)`` (N, K) lists node n's corners, K the largest
        valence, padded with element 0 at weight 0."""
        flat_nodes = self.conn.reshape(-1).astype(np.int64)      # (4E,)
        flat_elems = np.repeat(np.arange(self.n_elems), 4)
        vol_sum_at_node = np.zeros(self.n_nodes)
        np.add.at(vol_sum_at_node, flat_nodes, self.volumes[flat_elems])
        self.smooth_node_idx = flat_nodes
        self.smooth_elem_idx = flat_elems
        self.smooth_weights = (self.volumes[flat_elems]
                               / vol_sum_at_node[flat_nodes])
        order = np.argsort(flat_nodes, kind="stable")
        counts = np.bincount(flat_nodes, minlength=self.n_nodes)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(order.size) - starts[flat_nodes[order]]
        K = int(counts.max()) if counts.size else 0
        self._elem_of = np.zeros((self.n_nodes, K), dtype=np.int64)
        self._w_of = np.zeros((self.n_nodes, K))
        self._elem_of[flat_nodes[order], rank] = flat_elems[order]
        self._w_of[flat_nodes[order], rank] = self.smooth_weights[order]
        self._smoother_on = {}

    def _smoother(self, device):
        """(elem_of, w_of, conn) as tensors on ``device``, made once."""
        key = str(torch.device(device))
        if key not in self._smoother_on:
            as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
            self._smoother_on[key] = (as_t(self._elem_of), as_t(self._w_of),
                                      as_t(self.conn.astype(np.int64)))
        return self._smoother_on[key]

    def elems_to_nodes(self, q_elems: torch.Tensor) -> torch.Tensor:
        """Volume-weighted element->node average (N,) of a DG0 field (E,).

        Each node sums its padded row of weighted corner values: a gather
        and a row reduction, deterministic on CUDA (``index_add_`` there is
        atomic and its sums vary in the last bits from run to run)."""
        elem_of, w_of, _ = self._smoother(q_elems.device)
        return (w_of.to(q_elems.dtype) * q_elems[elem_of]).sum(1)

    def nodes_to_elems(self, q_nodes: torch.Tensor) -> torch.Tensor:
        """Uniform node->element average (E,) of a nodal field (N,)."""
        _, _, conn = self._smoother(q_nodes.device)
        return q_nodes[conn].mean(1)

    def smooth_elems(self, q_elems: torch.Tensor) -> torch.Tensor:
        """Element smoother: nodes_to_elems(elems_to_nodes(q))."""
        return self.nodes_to_elems(self.elems_to_nodes(q_elems))

    # -- tag queries ------------------------------------------------------- #
    def get_boundaries(self):
        return self.tri_tags

    def get_subdomains(self):
        return self.elem_tags

    def get_boundary_names(self):
        return list(self.dolfin_tags[2].keys())

    def get_subdomain_names(self):
        return list(self.dolfin_tags[3].keys())

    def get_boundary_tag(self, name):
        if name is None:
            return None
        return self.dolfin_tags[self.boundary_dim][name]

    def get_boundary_tags(self, name):
        if name is None:
            return None
        return self.boundary_tags[name]

    def get_subdomain_tag(self, name):
        return self.dolfin_tags[self.domain_dim][name]

    def get_parameter(self, param) -> np.ndarray:
        """Scalar / per-region / per-element parameter -> (n_elems,) f64."""
        if isinstance(param, (int, float)):
            return np.full(self.n_elems, float(param))
        if isinstance(param, dict):
            missing = [r for r in self.region_indices if r not in param]
            if missing:
                raise ValueError(f"Parameter dict missing regions: {missing}")
            out = np.zeros(self.n_elems)
            for region, idx in self.region_indices.items():
                out[idx] = float(param[region])
            return out
        param_arr = np.asarray(param, dtype=np.float64)
        if param_arr.shape[0] == self.n_regions != self.n_elems:
            out = np.zeros(self.n_elems)
            for i, idx in enumerate(self.region_indices.values()):
                out[idx] = param_arr[i]
            return out
        if param_arr.shape[0] == self.n_elems:
            return param_arr
        raise ValueError("Size of parameter list does not match neither "
                         "# of elements nor # of regions.")


class GridHandlerGMSH(Grid):
    """Load ``<grid_folder>/<geometry_name>.msh`` into a :class:`Grid`.

    ``reorder="band"`` renumbers nodes by reverse Cuthill-McKee and sorts
    elements by their minimum node before the geometry is built (the layout
    the momentum equation's f32 band operator is selected for).
    """

    def __init__(self, geometry_name: str, grid_folder: str,
                 reorder: str | None = None, nparts: int | None = None):
        self.grid_folder = grid_folder
        self.geometry_name = geometry_name
        path = os.path.join(grid_folder, f"{geometry_name}.msh")
        data: MshData = read_msh(path)
        points, tets, tet_tags = data.points, data.tets, data.tet_tags
        tris, tri_tags = data.tris, data.tri_tags
        self.elem_parts = None
        self.reorder_method = reorder or None
        if reorder:
            from .reorder import reorder_arrays
            points, tets, tet_tags, tris, tri_tags, parts = reorder_arrays(
                points, tets, tet_tags, tris, tri_tags,
                method=reorder, nparts=nparts)
            self.elem_parts = parts
        super().__init__(points, tets, tet_tags, tris, tri_tags,
                         data.field_data)
