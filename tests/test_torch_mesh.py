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
    box = st.GridBox(nx=2, ny=2, nz=2)
    for method in ("morton", "rcb"):
        with pytest.raises(NotImplementedError, match="not ported"):
            port_reordered(box, method=method, nparts=2)


def test_import_without_jax():
    """The port and all its modules import with jax made unimportable."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import safeincave_torch, safeincave_torch.interop, "
            "safeincave_torch.fem.bandkernel, safeincave_torch._build; "
            "assert 'safeincave_tpu' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
