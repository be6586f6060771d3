"""Parameterized multi-region cavern mesh generator.

Port of ``safeincave_tpu/mesh/cavern_gen.py``: host numpy throughout, so
points, tetrahedra, tags and a synthesized ``geom.msh`` equal the JAX
package's.  The reference regenerates its cavern/interlayer geometries with
gmsh-API scripts (generate_cavern_geo.py, generate_interlayer_spikes.py,
generate_A5_heterogeneous_tilted.py) that need the gmsh binary.  This module
provides the framework-owned equivalent capability: a salt box with a **revolved cavern profile** carved out
(cylindrical body + spherical caps, the shape family of the reference
``Wall_profile`` curves) and any number of **dipping interlayer bands**,
each its own tagged region, with the reference's region/boundary naming
(Salt_bottom / Interlayer_1 / Salt_middle / ... / Salt_top, boundary
"Cavern", box faces West..Top — the naming of
grids/cavern_interlayer_600_3D/geom.msh $PhysicalNames).

Structured Kuhn tetrahedra (mesh/boxgen.py) rather than an unstructured
gmsh tetrahedralization: the regular connectivity is a feature (tight RCM
bands, small block-ELL K), and the physics contract — regions,
boundary tags, cavern wall facets — is identical.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .boxgen import box_mesh
from .grid import Grid

_FACES = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]


@dataclass
class CavernProfile:
    """Revolved cavern profile: cylinder of radius ``radius`` between
    ``z_bottom``/``z_top`` with spherical end caps (cap height = radius)."""
    radius: float
    z_bottom: float
    z_top: float

    def contains(self, xyz, cx, cy):
        """Boolean mask of points strictly inside the revolved profile."""
        r2 = (xyz[:, 0] - cx) ** 2 + (xyz[:, 1] - cy) ** 2
        z = xyz[:, 2]
        zb, zt, R = self.z_bottom, self.z_top, self.radius
        body = (z >= zb) & (z <= zt) & (r2 < R * R)
        cap_t = (z > zt) & (r2 + (z - zt) ** 2 < R * R)
        cap_b = (z < zb) & (r2 + (z - zb) ** 2 < R * R)
        return body | cap_t | cap_b


@dataclass
class RevolvedProfile:
    """Axisymmetric cavern from a ``(z, r)`` polyline, optionally with a
    z-dependent axis x-offset (the tilted/asymmetric shape families).

    This is the same geometric contract as the reference's generator
    (generate_cavern_geo.py:3 "axisymmetric caverns
    defined by (z, R) profiles inside a 450x450x660 box"), evaluated
    directly against element centroids instead of via gmsh surfaces.
    """
    z_knots: tuple
    r_knots: tuple
    x_off_knots: tuple | None = None

    def contains(self, xyz, cx, cy):
        z = xyz[:, 2]
        r_at = np.interp(z, self.z_knots, self.r_knots, left=0.0, right=0.0)
        cx_at = cx
        if self.x_off_knots is not None:
            cx_at = cx + np.interp(z, self.z_knots, self.x_off_knots)
        r2 = (xyz[:, 0] - cx_at) ** 2 + (xyz[:, 1] - cy) ** 2
        return (z > self.z_knots[0]) & (z < self.z_knots[-1]) \
            & (r2 < r_at * r_at)

    def volume(self) -> float:
        """Exact solid-of-revolution volume (frustum stack), in m^3."""
        v = 0.0
        for i in range(len(self.z_knots) - 1):
            dz = self.z_knots[i + 1] - self.z_knots[i]
            r1, r2 = self.r_knots[i], self.r_knots[i + 1]
            v += np.pi * dz * (r1 * r1 + r1 * r2 + r2 * r2) / 3.0
        return float(v)

    def scaled_r(self, s: float) -> "RevolvedProfile":
        return RevolvedProfile(self.z_knots,
                               tuple(r * s for r in self.r_knots),
                               self.x_off_knots)


@dataclass
class ShapeUnion:
    """Union of revolved shapes (multi-chamber / tube / intrusion families)."""
    parts: tuple

    def contains(self, xyz, cx, cy):
        m = self.parts[0].contains(xyz, cx, cy)
        for p in self.parts[1:]:
            m = m | p.contains(xyz, cx, cy)
        return m

    def volume(self) -> float:
        return float(sum(p.volume() for p in self.parts))

    def scaled_r(self, s: float) -> "ShapeUnion":
        return ShapeUnion(tuple(p.scaled_r(s) for p in self.parts))


def fit_volume(shape, target_m3: float):
    """Radius-scale ``shape`` to the target cavern volume (closed form:
    V scales with s^2 under a pure radius scale - the reference bisects
    the same fit numerically, generate_cavern_geo.py:25-35)."""
    s = float(np.sqrt(target_m3 / shape.volume()))
    return shape.scaled_r(s), s


@dataclass
class InterlayerBand:
    """Planar dipping band: elements whose centroid satisfies
    ``|z - tan(dip) * (x - x_ref) - z_center| < thickness / 2``."""
    z_center: float
    thickness: float
    dip_deg: float = 0.0

    def signed_coord(self, cents, x_ref):
        return (cents[:, 2]
                - np.tan(np.radians(self.dip_deg)) * (cents[:, 0] - x_ref))


def cavern_mesh(L=450.0, H=660.0, n=12, nz=None,
                cavern: CavernProfile | None = None,
                interlayers: list[InterlayerBand] | None = None,
                overburden_from: float | None = None):
    """Build (points, tets, tet_tags, tris, tri_tags, field_data).

    Region naming follows the reference interlayer meshes: with k bands the
    volume regions are Salt_bottom, Interlayer_1, Salt_middle, ...,
    Interlayer_k, Salt_top (a single "Salt" region when k = 0).  Boundary
    names: West/East/South/North/Bottom/Top plus "Cavern" for the facets
    exposed by carving the profile.

    ``overburden_from`` splits everything above that z level off the top
    salt slab into an "Overburden" region — the reference's heterogeneous
    1200-level meshes (grids/cavern_A5_interlayer_3D semantics: non-salt
    cap rock above the salt formation) carry the same extra region.
    """
    nz = nz or max(2, int(round(n * H / L)))
    points, tets, tet_tags, tris, tri_tags, fd = box_mesh(L, L, H, n, n, nz)
    cx = cy = L / 2.0
    if cavern is None:
        cavern = CavernProfile(radius=0.18 * L, z_bottom=0.30 * H,
                               z_top=0.45 * H)
    interlayers = list(interlayers or [])

    cents = points[tets].mean(axis=1)
    keep = ~cavern.contains(cents, cx, cy)
    tets = tets[keep]
    cents = cents[keep]

    # --- volume regions: salt slabs interleaved with dipping bands ------- #
    interlayers.sort(key=lambda b: b.z_center)
    field_data = {}
    tag = 1
    if interlayers:
        tet_tags = np.zeros(tets.shape[0], dtype=np.int32)
        n_bands = len(interlayers)
        # Salt_bottom, Salt_middle[, Salt_middle_2, ...], Salt_top
        salt_names = ["Salt_bottom"] + [
            "Salt_middle" if i == 1 else f"Salt_middle_{i}"
            for i in range(1, n_bands)] + ["Salt_top"]
        for i, band in enumerate(interlayers):
            d = band.signed_coord(cents, cx)
            in_band = (np.abs(d - band.z_center) < band.thickness / 2.0)
            below = (tet_tags == 0) & ~in_band & (d < band.z_center)
            tet_tags[below] = tag
            field_data[salt_names[i]] = (tag, 3)
            tag += 1
            tet_tags[in_band & (tet_tags == 0)] = tag
            field_data[f"Interlayer_{i + 1}"] = (tag, 3)
            tag += 1
        tet_tags[tet_tags == 0] = tag
        field_data[salt_names[-1]] = (tag, 3)
        tag += 1
    else:
        tet_tags = np.ones(tets.shape[0], dtype=np.int32)
        field_data["Salt"] = (1, 3)
        tag = 2

    if overburden_from is not None:
        cap = cents[:, 2] > overburden_from
        tet_tags = np.where(cap, tag, tet_tags).astype(np.int32)
        field_data["Overburden"] = (tag, 3)
        tag += 1

    # --- boundary facets: exterior faces of the carved mesh -------------- #
    faces = tets[:, _FACES].reshape(-1, 3)
    fs = np.sort(faces, axis=1)
    _, first, counts = np.unique(fs, axis=0, return_index=True,
                                 return_counts=True)
    ext = faces[first[counts == 1]]
    fc = points[ext].mean(axis=1)
    tol = 1e-9 * max(L, H)
    name_tag = {}
    for nm in ("West", "East", "South", "North", "Bottom", "Top", "Cavern"):
        name_tag[nm] = tag
        field_data[nm] = (tag, 2)
        tag += 1
    plane = np.full(ext.shape[0], name_tag["Cavern"], dtype=np.int32)
    for nm, axis, val in (("West", 0, 0.0), ("East", 0, L),
                          ("South", 1, 0.0), ("North", 1, L),
                          ("Bottom", 2, 0.0), ("Top", 2, H)):
        on = np.abs(points[ext][:, :, axis] - val).max(axis=1) < max(tol, 1e-9)
        plane[on] = name_tag[nm]
    tris, tri_tags = ext, plane

    # --- drop interior nodes orphaned by the carve ----------------------- #
    used = np.unique(np.concatenate([tets.ravel(), tris.ravel()]))
    remap = -np.ones(points.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.size)
    return (points[used], remap[tets], tet_tags, remap[tris],
            np.asarray(tri_tags), field_data)


class GridCavern(Grid):
    """In-memory multi-region cavern grid (see :func:`cavern_mesh`)."""

    def __init__(self, L=450.0, H=660.0, n=12, nz=None, cavern=None,
                 interlayers=None, overburden_from=None):
        super().__init__(*cavern_mesh(L=L, H=H, n=n, nz=nz, cavern=cavern,
                                      interlayers=interlayers,
                                      overburden_from=overburden_from))


# --------------------------------------------------------------------- #
# Reference shape-family catalog
# --------------------------------------------------------------------- #
# The reference ships 43 grid directories - one committed gmsh mesh per
# cavern geometry variant (grids/cavern_*_600|1200_3D, generated by
# generate_cavern_geo.py / generate_interlayer_spikes.py /
# generate_A5_heterogeneous_tilted.py and hand-written .geo files).  The
# framework-owned equivalent is PROCEDURAL: each family below is an
# original (z, r[, x-offset]) profile in the same 450x450x660 domain with
# the same cavern depth band (z ~ 190..400) and the same 600k/1200k m^3
# volume normalization, synthesized on demand by ``find_grid`` - a mesh
# library that needs no gmsh install and no committed binary blobs.

_Z0, _Z1 = 190.0, 400.0       # cavern depth band (reference FL_BASE span)


def _capsule(z0=_Z0, z1=_Z1, R=45.0, x_off=None):
    """Cylinder with conical tips - the 'regular' profile."""
    return RevolvedProfile(
        (z0, z0 + R, z1 - R, z1), (0.0, R, R, 0.0),
        None if x_off is None else tuple(x_off))


def _wavy(n_knots, amp, R=45.0, phase=0.0, jagged=False, z0=_Z0, z1=_Z1):
    """Oscillating-radius barrel (bulbous/fastleached/irregular families)."""
    zs = np.linspace(z0, z1, n_knots)
    t = np.linspace(0.0, 1.0, n_knots)
    rs = R * (1.0 + amp * np.sin(2.0 * np.pi * (3.0 * t + phase)))
    if jagged:   # deterministic jitter, the 'uncontrolled leaching' look
        rs = rs * (1.0 + 0.12 * np.sin(17.0 * np.pi * t + 1.3))
    rs = rs * np.sin(np.pi * t) ** 0.5        # close the tips
    rs[0] = rs[-1] = 0.0
    return RevolvedProfile(tuple(zs), tuple(np.maximum(rs, 0.0)))


def _teardrop(wide_at_bottom=True, R=52.0, z0=_Z0, z1=_Z1):
    zs = np.linspace(z0, z1, 9)
    t = np.linspace(0.0, 1.0, 9)
    shape = (1.0 - t) ** 0.6 * t ** 0.25 if wide_at_bottom \
        else t ** 0.6 * (1.0 - t) ** 0.25
    rs = R * shape / shape.max()
    rs[0] = rs[-1] = 0.0
    return RevolvedProfile(tuple(zs), tuple(rs))


def _shape_family(family: str):
    """Cavern shape + default interlayer/overburden config for one
    reference grid family.  Returns (shape, interlayers, overburden_from)."""
    mid = 0.5 * (_Z0 + _Z1)
    band = lambda z, th=3.0, dip=0.0: InterlayerBand(z, th, dip)
    if family in ("regular", "nointerlayer", "spike_none"):
        return _capsule(), [], None
    if family == "asymmetric":
        # one-sided bulge: axis swings +x over the middle third
        zs = (_Z0, _Z0 + 45.0, mid, _Z1 - 45.0, _Z1)
        return RevolvedProfile(zs, (0.0, 45.0, 52.0, 45.0, 0.0),
                               (0.0, 8.0, 30.0, 8.0, 0.0)), [], None
    if family == "asymmetric_shelf":
        # sharp ledge: wide lower chamber stepping to a narrow upper bore
        zs = (_Z0, _Z0 + 40.0, mid - 1.0, mid + 1.0, _Z1 - 25.0, _Z1)
        return RevolvedProfile(zs, (0.0, 55.0, 55.0, 30.0, 30.0, 0.0),
                               (0.0, 5.0, 5.0, 18.0, 18.0, 0.0)), [], None
    if family == "bulbous_ledges":
        return _wavy(17, 0.30), [], None
    if family == "fastleached":
        return _wavy(23, 0.18, jagged=True), [], None
    if family == "irregular":
        return _wavy(15, 0.22, phase=0.37), [], None
    if family == "tilted":
        # straight capsule on a uniformly dipping axis
        return _capsule(x_off=(-35.0, -22.0, 22.0, 35.0)), [], None
    if family == "directcirculation":
        return _teardrop(wide_at_bottom=True), [], None
    if family == "reversedcirculation":
        return _teardrop(wide_at_bottom=False), [], None
    if family in ("multichamber", "multiplechamber"):
        lower = _capsule(_Z0, mid - 15.0, R=42.0)
        upper = _capsule(mid + 15.0, _Z1, R=42.0)
        neck = RevolvedProfile((mid - 20.0, mid + 20.0), (8.0, 8.0))
        return ShapeUnion((lower, upper, neck)), [], None
    if family == "tubefailure":
        # collapsed-tube scenario: main chamber + narrow riser to a small
        # upper pocket (reference: multi-chamber structure, hand-made .geo)
        main = _capsule(_Z0, mid + 10.0, R=48.0)
        tube = RevolvedProfile((mid + 5.0, _Z1 - 20.0), (6.0, 6.0))
        pocket = _capsule(_Z1 - 30.0, _Z1, R=18.0)
        return ShapeUnion((main, tube, pocket)), [], None
    if family == "vertical_intrusion":
        shaft = RevolvedProfile((_Z1 - 10.0, _Z1 + 120.0), (10.0, 10.0))
        return ShapeUnion((_capsule(), shaft)), [], None
    if family.startswith("spike_"):
        # interlayer spike/ledge variants (generate_interlayer_spikes.py):
        # same capsule, dipping 3 m bands through the cavern wall; il2x/il4x
        # scale the band thickness
        th = 3.0
        if family.endswith("_il2x"):
            th, family = 6.0, family[:-5]
        elif family.endswith("_il4x"):
            th, family = 12.0, family[:-5]
        bands = []
        if "upper" in family:
            bands = [band(mid + 75.0, th, dip=8.0)]
        elif "lower" in family:
            bands = [band(mid - 65.0, th, dip=8.0)]
        return _capsule(), bands, None
    if family in ("dipping_interlayer", "dipping"):
        return _capsule(), [band(mid - 65.0, 3.0, dip=12.0),
                           band(mid + 75.0, 3.0, dip=12.0)], None
    if family == "dipping_nointerlayer":
        return _capsule(), [], None
    if family in ("interlayer", "heterogenous"):
        return _capsule(), [band(mid - 65.0), band(mid + 75.0)], None
    if family == "interlayer_upperhalf":
        return _capsule(), [band(mid + 75.0, 3.0, dip=6.0)], None
    if family in ("overburden", "overburden_coarse"):
        return _capsule(), [], _Z1 + 110.0
    if family in ("A5", "a5"):
        # sonar-style slender wavy chimney (reference A5_PROFILE shape class)
        return _wavy(19, 0.25, R=38.0, phase=0.11, z0=_Z0 - 20.0,
                     z1=_Z1 + 20.0), [], None
    if family in ("A5_interlayer", "a5_interlayer"):
        shape = _wavy(19, 0.25, R=38.0, phase=0.11, z0=_Z0 - 20.0,
                      z1=_Z1 + 20.0)
        # localized tilted bands (generate_A5_heterogeneous_tilted.py:44-56:
        # upper band z=400, lower band z=230, 3 m thick)
        return shape, [band(230.0, 3.0, dip=10.0),
                       band(400.0, 3.0, dip=10.0)], None
    raise KeyError(f"unknown cavern shape family {family!r}")


SHAPE_FAMILIES = (
    "regular", "asymmetric", "asymmetric_shelf", "bulbous_ledges",
    "fastleached", "irregular", "tilted", "directcirculation",
    "reversedcirculation", "multichamber", "tubefailure",
    "vertical_intrusion", "spike_upper", "spike_lower", "spike_none",
    "spike_upper_il2x", "spike_upper_il4x", "spike_lower_il2x",
    "spike_lower_il4x", "dipping_interlayer", "dipping_nointerlayer",
    "interlayer", "interlayer_upperhalf", "overburden", "A5",
    "A5_interlayer",
)


def parse_grid_name(name: str):
    """``cavern_<family>[_600|_1200][_3D]`` -> (family, volume_m3) or None.

    Also accepts the reference's suffix-less directory names
    (cavern_regular, cavern_heterogenous, cavern_overburden[_coarse],
    cavern_multiplechamber, cavern_nointerlayer, cavern_irregular_*)."""
    if not name.startswith("cavern_"):
        return None
    s = name[len("cavern_"):]
    if s.endswith("_3D"):
        s = s[:-3]
    vol = 600e3
    for tag, v in (("_1200", 1200e3), ("_600", 600e3)):
        if s.endswith(tag):
            vol = v
            s = s[: -len(tag)]
            break
    alias = {"multiplechamber": "multichamber",
             "nointerlayer": "regular",
             "heterogenous": "interlayer",
             "overburden_coarse": "overburden",
             "irregular_finemesh": "irregular",
             "irregular_original": "irregular"}
    s = alias.get(s, s)
    try:
        _shape_family(s)
    except KeyError:
        return None
    return s, vol


def _catalog_mesh_arrays(name: str, n: int | None = None):
    """Raw mesh arrays for any catalog name, volume-normalized like the
    reference (600k/1200k m^3; generate_cavern_geo.py fit_volume)."""
    parsed = parse_grid_name(name)
    if parsed is None:
        raise KeyError(f"{name!r} is not a catalog cavern name")
    family, vol = parsed
    shape, bands, over = _shape_family(family)
    shape, _ = fit_volume(shape, vol)
    if n is None:
        n = 14 if vol <= 600e3 else 16      # ~24k / ~33k tets carved
    return cavern_mesh(L=450.0, H=660.0, n=n, cavern=shape,
                       interlayers=bands, overburden_from=over)


def build_catalog_grid(name: str, n: int | None = None) -> Grid:
    """In-memory :class:`Grid` for any catalog name."""
    return Grid(*_catalog_mesh_arrays(name, n=n))


def synthesize_grid(name: str, out_root: str, n: int | None = None) -> str:
    """Generate ``<out_root>/<name>/geom.msh`` for a catalog name and
    return the directory (find_grid's on-demand fallback)."""
    import os

    from .msh_io import write_msh
    points, tets, tet_tags, tris, tri_tags, fd = _catalog_mesh_arrays(
        name, n=n)
    d = os.path.join(out_root, name)
    os.makedirs(d, exist_ok=True)
    write_msh(os.path.join(d, "geom.msh"), points, tets, tet_tags,
              tris, tri_tags, fd)
    return d
