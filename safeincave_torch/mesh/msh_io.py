"""Pure-Python gmsh ``.msh`` reader (ASCII v2.2 and v4.1), numpy only.

Port of ``safeincave_tpu/mesh/msh_io.py``: the reader and the v2.2 writer
(byte-identical output).  Only tetrahedra (volume cells with region tags),
triangles (boundary facets with boundary tags) and the ``$PhysicalNames``
table are extracted.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# gmsh element type ids -> node counts
_N_NODES = {1: 2, 2: 3, 4: 4, 15: 1}
_TRIANGLE = 2
_TETRA = 4


@dataclass
class MshData:
    points: np.ndarray                     # (n_nodes, 3) float64
    tets: np.ndarray                       # (n_tets, 4) int32, local indices
    tet_tags: np.ndarray                   # (n_tets,) int32 physical tags
    tris: np.ndarray                       # (n_tris, 3) int32
    tri_tags: np.ndarray                   # (n_tris,) int32
    field_data: dict = field(default_factory=dict)  # name -> (tag, dim)


def read_msh(path: str) -> MshData:
    with open(path, "r") as f:
        lines = f.read().split("\n")
    i = 0
    sections: dict[str, list[str]] = {}
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("$") and not line.startswith("$End"):
            name = line[1:]
            j = i + 1
            end = f"$End{name}"
            while j < len(lines) and lines[j].strip() != end:
                j += 1
            sections[name] = lines[i + 1:j]
            i = j + 1
        else:
            i += 1

    if "MeshFormat" not in sections:
        raise ValueError(f"{path}: not a gmsh .msh file")
    version = sections["MeshFormat"][0].split()[0]

    field_data = {}
    if "PhysicalNames" in sections:
        for line in sections["PhysicalNames"][1:]:
            line = line.strip()
            if not line:
                continue
            parts = line.split(None, 2)
            dim, tag = int(parts[0]), int(parts[1])
            name = parts[2].strip().strip('"')
            field_data[name] = (tag, dim)

    if version.startswith("2"):
        points, node_map = _parse_nodes_v2(sections["Nodes"])
        tets, tet_tags, tris, tri_tags = _parse_elements_v2(
            sections["Elements"], node_map)
    elif version.startswith("4"):
        phys_of_entity = _parse_entities_v4(sections.get("Entities", []))
        points, node_map = _parse_nodes_v4(sections["Nodes"])
        tets, tet_tags, tris, tri_tags = _parse_elements_v4(
            sections["Elements"], node_map, phys_of_entity)
    else:
        raise ValueError(f"Unsupported .msh version {version}")

    return MshData(points=points, tets=tets, tet_tags=tet_tags,
                   tris=tris, tri_tags=tri_tags, field_data=field_data)


def write_msh(path: str, points, tets, tet_tags, tris, tri_tags, field_data):
    """Write a gmsh v2.2 ASCII mesh (inverse of :func:`read_msh`); node and
    element order are kept, so a natural-order box stays offset-structured."""
    points = np.asarray(points)
    tets = np.asarray(tets)
    tris = np.asarray(tris)
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$PhysicalNames\n{len(field_data)}\n")
        for name, (tag, dim) in field_data.items():
            f.write(f'{dim} {tag} "{name}"\n')
        f.write("$EndPhysicalNames\n")
        f.write(f"$Nodes\n{points.shape[0]}\n")
        for i, (x, y, z) in enumerate(points):
            f.write(f"{i + 1} {x:.16g} {y:.16g} {z:.16g}\n")
        f.write("$EndNodes\n")
        f.write(f"$Elements\n{tris.shape[0] + tets.shape[0]}\n")
        eid = 1
        for kind, cells, tags in ((2, tris, tri_tags), (4, tets, tet_tags)):
            for cell, tag in zip(cells, tags):
                nodes = " ".join(str(n + 1) for n in cell)
                f.write(f"{eid} {kind} 2 {tag} {tag} {nodes}\n")
                eid += 1
        f.write("$EndElements\n")


# ---------------------------------------------------------------------------
# v2.2
# ---------------------------------------------------------------------------
def _parse_nodes_v2(body):
    n = int(body[0])
    data = np.array(" ".join(body[1:n + 1]).split(), dtype=np.float64).reshape(n, 4)
    tags = data[:, 0].astype(np.int64)
    points = data[:, 1:4].copy()
    node_map = np.full(tags.max() + 1, -1, dtype=np.int64)
    node_map[tags] = np.arange(n)
    return points, node_map


def _parse_elements_v2(body, node_map):
    n = int(body[0])
    tets, tet_tags, tris, tri_tags = [], [], [], []
    for line in body[1:n + 1]:
        parts = line.split()
        if not parts:
            continue
        etype = int(parts[1])
        ntags = int(parts[2])
        phys = int(parts[3]) if ntags >= 1 else 0
        nodes = [int(x) for x in parts[3 + ntags:]]
        if etype == _TETRA:
            tets.append(nodes)
            tet_tags.append(phys)
        elif etype == _TRIANGLE:
            tris.append(nodes)
            tri_tags.append(phys)
    tets = node_map[np.asarray(tets, dtype=np.int64)] if tets else np.zeros((0, 4), np.int64)
    tris = node_map[np.asarray(tris, dtype=np.int64)] if tris else np.zeros((0, 3), np.int64)
    return (tets.astype(np.int32), np.asarray(tet_tags, np.int32),
            tris.astype(np.int32), np.asarray(tri_tags, np.int32))


# ---------------------------------------------------------------------------
# v4.1
# ---------------------------------------------------------------------------
def _parse_entities_v4(body):
    """Map (dim, entity_tag) -> first physical tag."""
    phys = {}
    if not body:
        return phys
    toks = " ".join(body).split()
    pos = 0

    def take(k):
        nonlocal pos
        vals = toks[pos:pos + k]
        pos += k
        return vals

    n_pt, n_cv, n_sf, n_vl = (int(x) for x in take(4))
    for _ in range(n_pt):
        tag = int(take(1)[0])
        take(3)  # x y z
        n_phys = int(take(1)[0])
        ptags = [int(x) for x in take(n_phys)]
        if ptags:
            phys[(0, tag)] = ptags[0]
    for dim, count in ((1, n_cv), (2, n_sf), (3, n_vl)):
        for _ in range(count):
            tag = int(take(1)[0])
            take(6)  # bounding box
            n_phys = int(take(1)[0])
            ptags = [int(x) for x in take(n_phys)]
            n_bnd = int(take(1)[0])
            take(n_bnd)
            if ptags:
                phys[(dim, tag)] = ptags[0]
    return phys


def _parse_nodes_v4(body):
    header = body[0].split()
    n_blocks, n_nodes = int(header[0]), int(header[1])
    max_tag = int(header[3])
    points = np.zeros((n_nodes, 3))
    tags = np.zeros(n_nodes, dtype=np.int64)
    li = 1
    out = 0
    for _ in range(n_blocks):
        bh = body[li].split()
        li += 1
        n_in_block = int(bh[3])
        for k in range(n_in_block):
            tags[out + k] = int(body[li + k])
        li += n_in_block
        for k in range(n_in_block):
            xyz = body[li + k].split()
            points[out + k] = [float(xyz[0]), float(xyz[1]), float(xyz[2])]
        li += n_in_block
        out += n_in_block
    node_map = np.full(max_tag + 1, -1, dtype=np.int64)
    node_map[tags] = np.arange(n_nodes)
    return points, node_map


def _parse_elements_v4(body, node_map, phys_of_entity):
    header = body[0].split()
    n_blocks = int(header[0])
    li = 1
    tets, tet_tags, tris, tri_tags = [], [], [], []
    for _ in range(n_blocks):
        bh = body[li].split()
        li += 1
        dim, etag, etype, n_in_block = (int(x) for x in bh[:4])
        phys = phys_of_entity.get((dim, etag), 0)
        nn = _N_NODES.get(etype)
        for k in range(n_in_block):
            parts = body[li + k].split()
            nodes = [int(x) for x in parts[1:1 + nn]] if nn else []
            if etype == _TETRA:
                tets.append(nodes)
                tet_tags.append(phys)
            elif etype == _TRIANGLE:
                tris.append(nodes)
                tri_tags.append(phys)
        li += n_in_block
    tets = node_map[np.asarray(tets, dtype=np.int64)] if tets else np.zeros((0, 4), np.int64)
    tris = node_map[np.asarray(tris, dtype=np.int64)] if tris else np.zeros((0, 3), np.int64)
    return (tets.astype(np.int32), np.asarray(tet_tags, np.int32),
            tris.astype(np.int32), np.asarray(tri_tags, np.int32))
