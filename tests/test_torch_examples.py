"""The examples tree on the port (safeincave_torch/examples), on the CPU:
each twin at tests/test_examples.py's shortened arguments against the JAX
example at the same arguments - run live where that takes under about 20 s
here (thermal/1_cube, mechanics/1_triaxial, mechanics/2_cube_regions),
otherwise from its golden - final saved fields at 1e-8 max|ref|, save times
and fixed-point counts equal, XDMF text equal, and the plot twin's
results.png written."""
import os
import sys

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
    """thermomechanics/2_cavern's twin is written; its mesh
    (cavern_overburden_coarse) is not in the repository, and the twin says
    so by name rather than running on another mesh.  When the mesh lands
    in grids/, this test becomes the twin's run against its golden."""
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
