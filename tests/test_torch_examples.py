"""The examples tree on the port (safeincave_torch/examples), on the CPU:
each twin at tests/test_examples.py's shortened arguments against the JAX
example at the same arguments - run live where that takes under about 20 s
here (thermal/1_cube, mechanics/1_triaxial, mechanics/2_cube_regions),
otherwise from its golden - final saved fields at 1e-8 max|ref|, save times
and fixed-point counts equal, XDMF text equal, and the plot twin's
results.png written."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_examples_check as chk  # noqa: E402
from torch_examples_check import one_torch_thread  # noqa: E402,F401
import torch_port_configs as cfg  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("name", ["thermal_cube", "triaxial",
                                  "cube_regions"])
def test_twin_against_live_jax_example(name, tmp_path):
    _, rec, out = chk.run_twin(name, tmp_path)
    ref, ref_out = chk.run_jax(name, tmp_path)
    chk.hold(rec, ref)
    chk.hold_xdmf(out, ref_root=ref_out)
    assert os.path.isfile(os.path.join(out, chk.PLOT_ROOTS[name][7:],
                                       "log.txt"))
    chk.plot(name, tmp_path)


@pytest.mark.parametrize("name", ["tm_cube", "cavern", "thermal_cavern"])
def test_twin_against_golden(name, tmp_path):
    _, rec, out = chk.run_twin(name, tmp_path)
    ref = chk.golden_record(name, "cpu")
    chk.hold(rec, ref)
    chk.hold_xdmf(out, rec=ref, tmp=tmp_path)
    chk.plot(name, tmp_path)


def test_thermomechanics_cavern_waits_for_its_mesh(tmp_path):
    """thermomechanics/2_cavern's twin, run as a user runs it, looks for
    the reference's cavern_overburden_coarse (geom.msh and geom.geo); the
    repository does not hold it, and the twin says so by name rather than
    running on another mesh.  Its run on the stand-in mesh is
    tests/test_torch_examples_tm_cavern.py."""
    mod = cfg.load_example("safeincave_torch",
                           "thermomechanics/2_cavern/main.py")
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        with pytest.raises(FileNotFoundError,
                           match="cavern_overburden_coarse"):
            mod["main"](device="cpu")
    finally:
        os.chdir(old)


def test_overburden_standin_same_in_both_packages(tmp_path):
    """The stand-in mesh of thermomechanics/2_cavern is the same whichever
    package writes it: nodes, tets, tags, names and the geom.geo text."""
    import safeincave_torch as st
    import safeincave_tpu as sc
    a = cfg.overburden_standin(sc, str(tmp_path / "jax"))
    b = cfg.overburden_standin(st, str(tmp_path / "port"))
    ma = sc.mesh.read_msh(os.path.join(a, "geom.msh"))
    mb = st.mesh.read_msh(os.path.join(b, "geom.msh"))
    for k in ("points", "tets", "tet_tags", "tris", "tri_tags"):
        np.testing.assert_array_equal(getattr(mb, k), getattr(ma, k),
                                      err_msg=k)
    assert mb.field_data == ma.field_data
    assert {"Salt", "Overburden", "Top", "Bottom", "Cavern", "West_salt",
            "West_ovb", "North_salt", "North_ovb"} <= set(ma.field_data)
    with open(os.path.join(a, "geom.geo")) as fa, \
            open(os.path.join(b, "geom.geo")) as fb:
        ga, gb = fa.read(), fb.read()
    assert ga.splitlines()[10:] == gb.splitlines()[10:]


def test_triaxial_sweep_forced_on_in_both_packages(tmp_path):
    """1_triaxial at the CPU arguments with the f32 sweep forced on in
    both packages (on the CPU "auto" keeps it off): the port's sweep does
    what the JAX package's does, fixed-point counts equal and fields at
    1e-8 max|ref|."""
    import safeincave_torch as st
    import safeincave_tpu as sc
    sweeps = []
    real = st.LinearMomentum._fp32_sweep

    def counted(self, *args, **kw):
        sweeps.append(1)
        return real(self, *args, **kw)
    st.LinearMomentum._fp32_sweep = counted
    try:
        with cfg.fp32_forced(st, True):
            _, rec, _ = chk.run_twin("triaxial", tmp_path)
    finally:
        st.LinearMomentum._fp32_sweep = real
    with cfg.fp32_forced(sc, True):
        ref, _ = chk.run_jax("triaxial", tmp_path)
    assert sweeps
    chk.hold(rec, ref)
