"""PyTorch port vs JAX package: mesh layer.

Points, connectivity, shape-function gradients, volumes, boundary facets and
tags must be identical (bitwise: both packages run the same numpy code in
the same term order) on a v2.2 gmsh fixture, a v4.1 gmsh fixture, the
band-reordered cavern_proxy_600 mesh and a band-reordered box.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import safeincave_tpu as sc
import safeincave_torch as st
from safeincave_tpu.mesh.reorder import reordered_grid as jax_reordered
from safeincave_torch.mesh.reorder import reordered_grid as port_reordered

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIELDS = ("points", "conn", "elem_tags", "tris", "tri_tags", "grad_N",
          "volumes", "centroids", "tri_areas", "tri_normals", "tri_owners")


def _cube(pkg):
    return pkg.GridHandlerGMSH("geom", os.path.join(HERE, "files",
                                                    "cube_coarse"))


def _tiny_v41(pkg):
    return pkg.GridHandlerGMSH("tiny_v41", os.path.join(HERE, "files"))


def _cavern600_band(pkg):
    return pkg.GridHandlerGMSH("geom", os.path.join(ROOT, "grids",
                                                    "cavern_proxy_600"),
                               reorder="band")


def _box_band(pkg):
    box = pkg.GridBox(Lx=1.0, Ly=2.0, Lz=1.5, nx=3, ny=3, nz=3)
    reorder = port_reordered if pkg is st else jax_reordered
    return reorder(box, method="band")[0]


@pytest.mark.parametrize("make", [_cube, _tiny_v41, _cavern600_band,
                                  _box_band],
                         ids=["cube_coarse", "tiny_v41", "cavern600_band",
                              "box_band"])
def test_grid_identical_to_jax(make):
    g_port, g_jax = make(st), make(sc)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(g_port, name),
                                      np.asarray(getattr(g_jax, name)),
                                      err_msg=name)
    assert g_port.dolfin_tags == g_jax.dolfin_tags
    assert g_port.reorder_method == g_jax.reorder_method
    for name in g_jax.get_boundary_names():
        np.testing.assert_array_equal(g_port.get_boundary_tags(name),
                                      g_jax.get_boundary_tags(name))
    for name, idx in g_jax.region_indices.items():
        np.testing.assert_array_equal(g_port.region_indices[name], idx)
    assert (g_port.Lx, g_port.Ly, g_port.Lz) == (g_jax.Lx, g_jax.Ly,
                                                 g_jax.Lz)


def test_get_parameter_matches_jax():
    g_port, g_jax = _cube(st), _cube(sc)
    regions = g_jax.get_subdomain_names()
    per_region = {r: 1.0 + i for i, r in enumerate(regions)}
    rng = np.random.default_rng(0)
    per_elem = rng.normal(size=g_jax.n_elems)
    for param in (3.5, per_region, per_elem, [2.0] * len(regions)):
        np.testing.assert_array_equal(g_port.get_parameter(param),
                                      np.asarray(g_jax.get_parameter(param)))


@pytest.mark.parametrize("fun", [
    lambda x, y, z: 2.0 * x - y * z + 1.0,                 # takes arrays
    lambda x, y, z: float(np.hypot(x, y)) if z > 0.5 else 3.0,  # scalars only
    lambda x, y, z: 7.0,                                   # a constant
], ids=["vectorized", "pointwise", "constant"])
def test_field_samplers_match_jax(fun):
    g_port, g_jax = _cube(st), _cube(sc)
    for name in ("create_field_nodes", "create_field_elems"):
        got = getattr(st.Utils, name)(g_port, fun)
        want = np.asarray(getattr(sc.Utils, name)(g_jax, fun))
        assert got.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_json_round_trip_matches_jax(tmp_path):
    data = {"grid": {"path": "grids/x", "name": "geom"},
            "values": [0.0, 1e6, 2.5e-3], "active": True}
    st.Utils.save_json(data, str(tmp_path / "port.json"))
    sc.Utils.save_json(data, str(tmp_path / "jax.json"))
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())
    assert st.Utils.read_json(str(tmp_path / "jax.json")) == data


def test_find_grid_matches_jax():
    """The repo fixture that the cavern benchmark falls back to; a name
    that is neither a fixture nor (in the port) synthesizable raises."""
    args = ("cavern_regular_600_3D", "cavern_proxy_600")
    assert os.path.samefile(st.Utils.find_grid(*args),
                            sc.Utils.find_grid(*args))
    assert st.Utils.find_grid("cavern_proxy_600") == st.Utils.find_grid(*args)
    with pytest.raises(FileNotFoundError):
        st.Utils.find_grid("no_such_grid")


def test_unported_reorderings_raise():
    """Every ordering of the JAX package is ported (tests/
    test_torch_reorder.py holds Morton and RCB against it); what raises is a
    method neither package has."""
    box = st.GridBox(nx=2, ny=2, nz=2)
    for method in ("morton", "rcb"):
        grid = port_reordered(box, method=method, nparts=2)[0]
        assert grid.reorder_method == method
    with pytest.raises(ValueError, match="unknown reorder method"):
        port_reordered(box, method="hilbert")


def test_import_without_jax():
    """The port and all its modules import with jax made unimportable, and
    without importing h5py (only opening HDF5 files needs it)."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import safeincave_torch, safeincave_torch.interop, "
            "safeincave_torch.fem.bandkernel, safeincave_torch._build, "
            "safeincave_torch.app.sim_cli, safeincave_torch.postproc, "
            "safeincave_torch.matpoint, safeincave_torch.mesh.cavern_gen, "
            "safeincave_torch.mesh.native, safeincave_torch.fem.blockell; "
            "assert 'h5py' not in sys.modules; "
            "assert 'safeincave_tpu' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# --------------------------------------------------------------------------- #
# node <-> element smoother and the gmsh writer
# --------------------------------------------------------------------------- #
def _box_natural(pkg):
    return pkg.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=5, ny=4, nz=6)


@pytest.mark.parametrize("make", [_cavern600_band, _box_natural, _cube],
                         ids=["cavern600_band", "box", "cube_coarse"])
def test_smoother_matches_jax(make):
    """elems_to_nodes, nodes_to_elems and smooth_elems on a seeded field,
    1e-13 of max|ref|; the host weights are bitwise the JAX package's."""
    g_port, g_jax = make(st), make(sc)
    for name in ("smooth_node_idx", "smooth_elem_idx", "smooth_weights"):
        np.testing.assert_array_equal(getattr(g_port, name),
                                      np.asarray(getattr(g_jax, name)))
    rng = np.random.default_rng(1)
    q_e = 1e7 * rng.normal(size=g_jax.n_elems)
    q_n = 1e7 * rng.normal(size=g_jax.n_nodes)
    for fn, q in (("elems_to_nodes", q_e), ("nodes_to_elems", q_n),
                  ("smooth_elems", q_e)):
        got = getattr(g_port, fn)(torch.as_tensor(q)).numpy()
        want = np.asarray(getattr(g_jax, fn)(q))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max(), fn


def test_smoother_preserves_constants():
    """Volume weights sum to one at every node: a constant field smooths to
    itself."""
    g = _cavern600_band(st)
    one = torch.ones(g.n_elems, dtype=torch.float64)
    torch.testing.assert_close(g.smooth_elems(3.5 * one), 3.5 * one,
                               rtol=1e-14, atol=0)


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.mesh.box_mesh(nx=2, ny=2, nz=3),
    lambda pkg: pkg.mesh.box_mesh(600.0, 600.0, 800.0, 4, 3, 5),
    lambda pkg: pkg.mesh.read_msh(os.path.join(HERE, "files", "cube_coarse",
                                               "geom.msh")),
], ids=["box_2x2x3", "box_600", "cube_coarse"])
def test_write_msh_byte_identical(tmp_path, make):
    """The port's writer gives the JAX writer's bytes for the same arrays,
    and the file reads back through the port's reader unchanged."""
    args = make(st)
    if not isinstance(args, tuple):
        args = (args.points, args.tets, args.tet_tags, args.tris,
                args.tri_tags, args.field_data)
    st.mesh.write_msh(str(tmp_path / "port.msh"), *args)
    sc.mesh.write_msh(str(tmp_path / "jax.msh"), *args)
    assert (tmp_path / "port.msh").read_bytes() == \
        (tmp_path / "jax.msh").read_bytes()
    back = st.mesh.read_msh(str(tmp_path / "port.msh"))
    for got, want in zip((back.points, back.tets, back.tet_tags, back.tris,
                          back.tri_tags), args[:5]):
        np.testing.assert_array_equal(got, want)
    assert back.field_data == args[5]
