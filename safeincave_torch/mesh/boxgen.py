"""Structured box tetrahedral mesher (port of safeincave_tpu/mesh/boxgen.py).

A box [0,Lx]x[0,Ly]x[0,Lz] split into nx*ny*nz hexes, each cut into 6 tets
(Kuhn), with the six boundaries named WEST/EAST/SOUTH/NORTH/BOTTOM/TOP
(tags 1-6) and one BODY region (tag 1).
"""
from __future__ import annotations

import numpy as np

from .grid import Grid

# 6-tet (Kuhn) decomposition of the unit cube, all sharing the main diagonal
# (0,0,0)-(1,1,1); vertex order (i, j, k) -> i + 2j + 4k
_KUHN_TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], dtype=np.int64)

_CORNER_OFFSETS = np.array([(i, j, k) for k in (0, 1) for j in (0, 1)
                            for i in (0, 1)], dtype=np.int64)

BOX_FIELD_DATA = {
    "WEST": (1, 2), "EAST": (2, 2), "SOUTH": (3, 2), "NORTH": (4, 2),
    "BOTTOM": (5, 2), "TOP": (6, 2), "BODY": (1, 3),
}


def box_mesh(Lx=1.0, Ly=1.0, Lz=1.0, nx=4, ny=4, nz=4):
    """Return (points, tets, tet_tags, tris, tri_tags, field_data)."""
    xs = np.linspace(0.0, Lx, nx + 1)
    ys = np.linspace(0.0, Ly, ny + 1)
    zs = np.linspace(0.0, Lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    base = np.stack([I.ravel(), J.ravel(), K.ravel()], axis=1)  # (H, 3)
    corners = np.empty((base.shape[0], 8), dtype=np.int64)
    for c, (di, dj, dk) in enumerate(_CORNER_OFFSETS):
        corners[:, c] = nid(base[:, 0] + di, base[:, 1] + dj, base[:, 2] + dk)

    tets = corners[:, _KUHN_TETS].reshape(-1, 4)
    tet_tags = np.ones(tets.shape[0], dtype=np.int32)

    # boundary triangles: exterior faces of the tets lying on box planes
    faces = tets[:, [[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]]].reshape(-1, 3)
    fs = np.sort(faces, axis=1)
    _, first, counts = np.unique(fs, axis=0, return_index=True,
                                 return_counts=True)
    ext = faces[first[counts == 1]]

    p = points[ext]
    tol = 1e-12 * max(Lx, Ly, Lz)
    tris, tri_tags = [], []
    planes = [(0, 0.0, 1), (0, Lx, 2), (1, 0.0, 3), (1, Ly, 4),
              (2, 0.0, 5), (2, Lz, 6)]
    assigned = np.zeros(ext.shape[0], dtype=bool)
    for axis, val, tag in planes:
        on = np.all(np.abs(p[:, :, axis] - val) < max(tol, 1e-12),
                    axis=1) & ~assigned
        assigned |= on
        tris.append(ext[on])
        tri_tags.append(np.full(on.sum(), tag, dtype=np.int32))
    tris = np.concatenate(tris, axis=0)
    tri_tags = np.concatenate(tri_tags)
    return points, tets.astype(np.int32), tet_tags, tris.astype(np.int32), \
        tri_tags, dict(BOX_FIELD_DATA)


class GridBox(Grid):
    """Built-in box grid."""

    def __init__(self, Lx=1.0, Ly=1.0, Lz=1.0, nx=4, ny=4, nz=4):
        super().__init__(*box_mesh(Lx, Ly, Lz, nx, ny, nz))
