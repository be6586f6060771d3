"""PyTorch port vs JAX package: the cavern mesh generator and its catalog.
Host numpy on both sides: points, tetrahedra and tags are equal, and a
synthesized ``geom.msh`` is the same file byte for byte.  Synthesis writes
into a temporary directory.
"""
import os

import numpy as np
import pytest
import torch

import safeincave_torch as st
from safeincave_tpu.mesh import cavern_gen as jgen
from safeincave_torch.mesh import cavern_gen as pgen

torch.set_num_threads(1)


def _same_grid(p, j):
    np.testing.assert_array_equal(p.points, j.points)
    np.testing.assert_array_equal(p.conn, j.conn)
    np.testing.assert_array_equal(p.elem_tags, j.elem_tags)
    np.testing.assert_array_equal(p.tris, j.tris)
    np.testing.assert_array_equal(p.tri_tags, j.tri_tags)
    assert p.get_boundary_names() == j.get_boundary_names()
    assert p.get_subdomain_names() == j.get_subdomain_names()


@pytest.mark.parametrize("case", ["default", "interlayers", "overburden",
                                  "union"])
def test_grid_cavern_equal(case):
    def build(gen):
        if case == "default":
            return gen.GridCavern(n=6)
        if case == "interlayers":
            bands = [gen.InterlayerBand(250.0, 30.0, dip_deg=6.0),
                     gen.InterlayerBand(420.0, 25.0)]
            return gen.GridCavern(n=7, interlayers=bands,
                                  cavern=gen.CavernProfile(45.0, 240.0,
                                                           360.0))
        if case == "overburden":
            return gen.GridCavern(n=6, nz=9, overburden_from=520.0)
        prof = gen.RevolvedProfile((190.0, 240.0, 350.0, 400.0),
                                   (0.0, 40.0, 55.0, 0.0))
        shape = gen.ShapeUnion((prof, gen.CavernProfile(25.0, 380.0,
                                                        450.0)))
        return gen.GridCavern(n=7, cavern=shape)

    _same_grid(build(pgen), build(jgen))


def test_fit_volume_equal():
    knots = ((190.0, 240.0, 350.0, 400.0), (0.0, 40.0, 55.0, 0.0))
    shape_p, s_p = pgen.fit_volume(pgen.RevolvedProfile(*knots), 600e3)
    shape_j, s_j = jgen.fit_volume(jgen.RevolvedProfile(*knots), 600e3)
    assert s_p == s_j
    assert shape_p.z_knots == shape_j.z_knots
    np.testing.assert_array_equal(shape_p.r_knots, shape_j.r_knots)


@pytest.mark.parametrize("name", [
    "cavern_regular_600_3D", "cavern_interlayer_1200_3D",
    "cavern_multiplechamber_600", "cavern_irregular_finemesh_1200_3D",
    "cavern_overburden_coarse_600_3D", "cavern_tilted_600_3D"])
def test_catalog_names_and_grids_equal(name):
    assert pgen.parse_grid_name(name) == jgen.parse_grid_name(name)
    if pgen.parse_grid_name(name) is None:
        return
    _same_grid(pgen.build_catalog_grid(name, n=6),
               jgen.build_catalog_grid(name, n=6))


def test_parse_grid_name_rejects_what_the_jax_package_rejects():
    for name in ("cube", "cavern_", "cavern_nonsense_600_3D", "box_600_3D"):
        assert pgen.parse_grid_name(name) is None
        assert jgen.parse_grid_name(name) is None


def test_synthesized_msh_is_the_same_file(tmp_path):
    d_p = pgen.synthesize_grid("cavern_regular_600_3D", str(tmp_path / "p"),
                               n=6)
    d_j = jgen.synthesize_grid("cavern_regular_600_3D", str(tmp_path / "j"),
                               n=6)
    with open(os.path.join(d_p, "geom.msh"), "rb") as f:
        a = f.read()
    with open(os.path.join(d_j, "geom.msh"), "rb") as f:
        b = f.read()
    assert a == b and len(a) > 10_000
    # and it loads through the handler, in any order the port offers
    g = st.GridHandlerGMSH("geom", d_p, reorder="morton")
    assert g.n_elems == pgen.build_catalog_grid("cavern_regular_600_3D",
                                                n=6).n_elems
    assert "Cavern" in g.get_boundary_names()


def test_find_grid_synthesizes_a_catalog_name(tmp_path, monkeypatch):
    """A catalog name with no fixture is synthesized under the grids
    directory ``find_grid`` searches; here that directory is a temporary
    one, and the coarse size keeps it quick."""
    from safeincave_torch import utils as put
    import safeincave_torch.mesh.cavern_gen as gen
    monkeypatch.setenv("SAFEINCAVE_NO_REFERENCE", "1")
    made = []
    real = gen.synthesize_grid

    def into_tmp(name, out_root, n=None):
        made.append(out_root)
        return real(name, str(tmp_path), n=6)

    monkeypatch.setattr(gen, "synthesize_grid", into_tmp)
    d = put.find_grid("cavern_fastleached_600_3D")
    assert d == os.path.join(str(tmp_path), "cavern_fastleached_600_3D")
    assert os.path.isfile(os.path.join(d, "geom.msh"))
    assert made == [os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(put.__file__))), "grids")]
    with pytest.raises(FileNotFoundError):
        put.find_grid("cavern_nonsense_600_3D")
