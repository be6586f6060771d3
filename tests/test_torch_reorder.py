"""PyTorch port vs JAX package: Morton and RCB reordering, the native
preprocessing library against its numpy versions, ``GridBoxRegions`` and
the search order of ``find_grid``.  Everything here is integer or host
float64 work: equality is exact.
"""
import os

import numpy as np
import pytest
import torch

import safeincave_tpu as sc
import safeincave_torch as st
from safeincave_tpu.mesh import native as jax_native
from safeincave_tpu.mesh.reorder import reorder_arrays as jax_reorder_arrays
from safeincave_tpu.mesh.reorder import reordered_grid as jax_reordered
from safeincave_torch.mesh import native
from safeincave_torch.mesh.reorder import reorder_arrays, reordered_grid

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CUBE = os.path.join(HERE, "..", "grids", "cube")


def _boxes(nx=5):
    kw = dict(Lx=3.0, Ly=2.0, Lz=1.0, nx=nx, ny=nx - 1, nz=nx + 1)
    return sc.GridBox(**kw), st.GridBox(**kw)


@pytest.mark.parametrize("method,nparts", [("morton", None), ("rcb", 4),
                                           ("rcb", 3), ("band", None)])
def test_reordered_grid_equal(method, nparts):
    gj, gp = _boxes()
    j, order_j, perm_j = jax_reordered(gj, method=method, nparts=nparts)
    p, order_p, perm_p = reordered_grid(gp, method=method, nparts=nparts)
    np.testing.assert_array_equal(order_p, order_j)
    np.testing.assert_array_equal(perm_p, perm_j)
    np.testing.assert_array_equal(p.conn, j.conn)
    np.testing.assert_array_equal(p.points, j.points)
    np.testing.assert_array_equal(p.elem_tags, j.elem_tags)
    np.testing.assert_array_equal(p.tris, j.tris)
    assert p.reorder_method == j.reorder_method == method
    if method == "rcb":
        np.testing.assert_array_equal(p.elem_parts, j.elem_parts)
        assert len(np.unique(p.elem_parts)) == nparts
    # a reordered grid is the same mesh
    np.testing.assert_allclose(np.sort(p.volumes), np.sort(gp.volumes),
                               rtol=1e-13)


@pytest.mark.parametrize("method,nparts", [("morton", None), ("rcb", 4)])
def test_handler_reorder_option_equal(method, nparts):
    j = sc.GridHandlerGMSH("geom", CUBE, reorder=method, nparts=nparts)
    p = st.GridHandlerGMSH("geom", CUBE, reorder=method, nparts=nparts)
    np.testing.assert_array_equal(p.conn, j.conn)
    np.testing.assert_array_equal(p.points, j.points)
    np.testing.assert_array_equal(p.elem_tags, j.elem_tags)
    assert p.reorder_method == method
    if method == "rcb":
        np.testing.assert_array_equal(p.elem_parts, j.elem_parts)
    else:
        assert p.elem_parts is None
    assert st.fem.momentum.select_backend(p, "cuda") is None


def test_reorder_arrays_equal_and_unknown_method_raises():
    gj, gp = _boxes(4)
    args_j = (gj.points, gj.conn, gj.elem_tags, gj.tris, gj.tri_tags)
    args_p = (gp.points, gp.conn, gp.elem_tags, gp.tris, gp.tri_tags)
    for method, nparts in (("morton", None), ("rcb", 2)):
        out_j = jax_reorder_arrays(*args_j, method=method, nparts=nparts)
        out_p = reorder_arrays(*args_p, method=method, nparts=nparts)
        for a, b in zip(out_p, out_j):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown reorder method"):
        reorder_arrays(*args_p, method="hilbert")
    with pytest.raises(ValueError, match="nparts"):
        reordered_grid(gp, method="rcb")


@pytest.mark.parametrize("fn", ["morton_order", "rcb_partition",
                                "node_first_touch", "tet_adjacency"])
def test_native_against_numpy_and_the_jax_package(fn):
    """The library (built with the host compiler into the package's
    ``_build/``) gives the JAX package's loader's integers (the same
    source), and the numpy version the same permutation, partition,
    first-touch numbering and adjacency."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no host compiler: only the numpy versions can run")
    assert native.available(), "g++ is present: the library must build"
    assert os.path.dirname(native._lib._name) == st._build.BUILD_DIR
    _, gp = _boxes(5)
    rng = np.random.default_rng(0)
    # centroids without ties: where two coordinates are equal, the
    # library's partial sort and numpy's stable sort may split differently
    cents = np.asarray(gp.centroids) + 1e-3 * rng.random((gp.n_elems, 3))
    conn = np.asarray(gp.conn)[rng.permutation(gp.n_elems)]
    args = {"morton_order": (cents,), "rcb_partition": (cents, 5),
            "node_first_touch": (conn, gp.n_nodes + 3),
            "tet_adjacency": (conn,)}[fn]
    lib = getattr(native, fn)(*args, native=True)
    plain = getattr(native, fn)(*args, native=False)
    ref = getattr(jax_native, fn)(*args)
    lib, plain, ref = (x if isinstance(x, tuple) else (x,)
                       for x in (lib, plain, ref))
    for a, c in zip(lib, ref):
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(lib[0], plain[0])
    if fn == "rcb_partition":
        # the element order inside a block is the library's recursion order
        # and numpy's stable sort: both group the blocks in ascending order
        for parts, order in (lib, plain):
            assert sorted(order) == list(range(len(parts)))
            assert (np.diff(parts[order]) >= 0).all()


def test_tet_adjacency_is_symmetric():
    _, gp = _boxes(4)
    adj = native.tet_adjacency(gp.conn, native=False)
    e, f = np.nonzero(adj >= 0)
    back = adj[adj[e, f]]
    assert (back == e[:, None]).any(axis=1).all()
    assert (adj < 0).sum() == gp.tris.shape[0]


@pytest.mark.parametrize("axis,at", [(2, None), (0, 1.0)])
def test_grid_box_regions_tags(axis, at):
    kw = dict(Lx=3.0, Ly=2.0, Lz=1.0, nx=4, ny=3, nz=4, split_axis=axis,
              split_at=at)
    j, p = sc.GridBoxRegions(**kw), st.GridBoxRegions(**kw)
    np.testing.assert_array_equal(p.elem_tags, j.elem_tags)
    np.testing.assert_array_equal(p.conn, j.conn)
    assert p.get_subdomain_names() == j.get_subdomain_names()
    assert set(p.region_indices) == {"OMEGA_A", "OMEGA_B"}
    for name in p.region_indices:
        np.testing.assert_array_equal(p.region_indices[name],
                                      j.region_indices[name])
    # the per-region parameter idiom of examples/mechanics/2_cube_regions
    np.testing.assert_array_equal(p.get_parameter([1.0, 2.0]),
                                  np.asarray(j.get_parameter([1.0, 2.0])))


def test_find_grid_order(tmp_path, monkeypatch):
    """Mounted reference first, SAFEINCAVE_NO_REFERENCE=1 skips it, then
    the repository's grids (fallback before name), then the catalog; both
    packages resolve the same directory at every stage."""
    from safeincave_torch import utils as put
    mount = put.REFERENCE_GRIDS
    os.makedirs(tmp_path / "cavern_proxy_600")
    (tmp_path / "cavern_proxy_600" / "geom.msh").write_text("")
    real_isfile = os.path.isfile

    def isfile(path):
        path = os.fspath(path)
        if path.startswith(mount + os.sep):
            path = os.path.join(tmp_path, os.path.relpath(path, mount))
        return real_isfile(path)

    def both(*args, **kw):
        a = st.Utils.find_grid(*args, **kw)
        b = sc.Utils.find_grid(*args, **kw)
        assert os.path.realpath(a) == os.path.realpath(b)
        return a

    monkeypatch.delenv("SAFEINCAVE_NO_REFERENCE", raising=False)
    repo = both("cavern_proxy_600")
    assert os.path.realpath(repo) == os.path.realpath(
        os.path.join(HERE, "..", "grids", "cavern_proxy_600"))
    monkeypatch.setattr(os.path, "isfile", isfile)
    assert both("cavern_proxy_600") == os.path.join(mount, "cavern_proxy_600")
    # a name the mount lacks falls through to the repository
    assert both("cube") == os.path.join(os.path.dirname(repo), "cube")
    monkeypatch.setenv("SAFEINCAVE_NO_REFERENCE", "1")
    assert both("cavern_proxy_600") == repo
    assert both("cavern_regular_600_3D", fallback="cavern_proxy_600") == repo
    with pytest.raises(FileNotFoundError):
        st.Utils.find_grid("no_such_grid")
