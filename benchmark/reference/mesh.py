"""The plain reference's mesh: a gmsh v2.2 ASCII reader and the P1
tetrahedron geometry, in numpy.

It reads the mesh file in the file's own node and element order (the
program under test renumbers them); the judge matches the two by
coordinates.  Shape-function gradients come from the inverse of each
element's Jacobian, boundary triangles find their tetrahedron through a
dictionary of sorted faces, and the outward normal points away from that
tetrahedron's centroid.
"""
from __future__ import annotations

import numpy as np


class Mesh:
    """points (N, 3), tets (E, 4), tet_tags (E,), tris (F, 3), tri_tags (F,),
    names {name: (tag, dim)}, and the geometry: vol (E,), grad (E, 4, 3),
    tri_area (F,), tri_normal (F, 3)."""

    def __init__(self, path: str):
        with open(path) as f:
            text = f.read()
        sections, name, body = {}, None, []
        for line in text.splitlines():
            s = line.strip()
            if s.startswith("$End"):
                sections[name] = body
                name = None
            elif s.startswith("$"):
                name, body = s[1:], []
            elif name is not None:
                body.append(s)
        if not sections["MeshFormat"][0].startswith("2"):
            raise ValueError(f"{path}: the reference reads gmsh v2.2 only")
        self.names = {}
        for line in sections.get("PhysicalNames", [])[1:]:
            if line:
                dim, tag, nm = line.split(None, 2)
                self.names[nm.strip('"')] = (int(tag), int(dim))
        nodes = sections["Nodes"]
        n = int(nodes[0])
        raw = np.array(" ".join(nodes[1:n + 1]).split(), float).reshape(n, 4)
        index = {int(t): i for i, t in enumerate(raw[:, 0])}
        self.points = raw[:, 1:].copy()
        tets, ttag, tris, ftag = [], [], [], []
        elems = sections["Elements"]
        for line in elems[1:int(elems[0]) + 1]:
            p = [int(x) for x in line.split()]
            kind, ntags = p[1], p[2]
            conn = [index[v] for v in p[3 + ntags:]]
            if kind == 4:
                tets.append(conn)
                ttag.append(p[3])
            elif kind == 2:
                tris.append(conn)
                ftag.append(p[3])
        self.tets = np.asarray(tets, np.int64)
        self.tet_tags = np.asarray(ttag, np.int64)
        self.tris = np.asarray(tris, np.int64)
        self.tri_tags = np.asarray(ftag, np.int64)
        self._geometry()

    @property
    def n_nodes(self):
        return self.points.shape[0]

    @property
    def n_elems(self):
        return self.tets.shape[0]

    def _geometry(self):
        x = self.points[self.tets]                       # (E, 4, 3)
        J = np.stack([x[:, k] - x[:, 0] for k in (1, 2, 3)], axis=2)
        self.vol = np.abs(np.linalg.det(J)) / 6.0
        # grad N_k = J^-T e_k for k = 1..3, grad N_0 = -(their sum)
        g = np.linalg.inv(J).transpose(0, 2, 1)          # columns: grad N_k
        g123 = g.transpose(0, 2, 1)                      # rows
        self.grad = np.concatenate([-g123.sum(1, keepdims=True), g123], 1)
        self.centroid = x.mean(1)
        owner = {}
        for e, t in enumerate(self.tets):
            for face in ((t[1], t[2], t[3]), (t[0], t[2], t[3]),
                         (t[0], t[1], t[3]), (t[0], t[1], t[2])):
                owner[tuple(sorted(face))] = e
        a, b, c = (self.points[self.tris[:, k]] for k in range(3))
        nvec = 0.5 * np.cross(b - a, c - a)
        self.tri_area = np.linalg.norm(nvec, axis=1)
        normal = nvec / self.tri_area[:, None]
        owners = np.array([owner[tuple(sorted(t))] for t in self.tris],
                          np.int64)
        out = (((a + b + c) / 3.0 - self.centroid[owners]) * normal).sum(1)
        self.tri_normal = np.where(out[:, None] >= 0, normal, -normal)

    # -- tags ------------------------------------------------------------- #
    def boundary_names(self):
        return [n for n, (_, d) in self.names.items() if d == 2]

    def region_names(self):
        return [n for n, (_, d) in self.names.items() if d == 3]

    def facets(self, name):
        return np.nonzero(self.tri_tags == self.names[name][0])[0]

    def region_of(self, name):
        return self.tet_tags == self.names[name][0]

    # -- the output smoother: volume-weighted element -> node average, then
    # the plain mean of an element's four nodes -------------------------- #
    def smooth(self, q):
        """(E,) -> (E,) for a float tensor ``q`` on any device."""
        import torch
        tets = torch.as_tensor(self.tets, device=q.device)
        vol = torch.as_tensor(self.vol, dtype=q.dtype, device=q.device)
        num = torch.zeros(self.n_nodes, dtype=q.dtype, device=q.device)
        den = torch.zeros_like(num)
        for k in range(4):
            num.index_add_(0, tets[:, k], vol * q)
            den.index_add_(0, tets[:, k], vol)
        return (num / den)[tets].mean(1)
