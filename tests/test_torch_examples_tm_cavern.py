"""thermomechanics/2_cavern's twin on the CPU, on a stand-in for the
reference's cavern_overburden_coarse mesh, which the repository does not
hold (``torch_port_configs.overburden_standin``: the catalog's overburden
mesh, 24,582 tets, with its side faces split at the cap), against the JAX
script's golden on the same mesh at the CPU tests' cut depth (one
equilibrium step of 1 day, one operation step of 0.5 day: ~2 min here, so
the file runs on a worker of its own).  Final saved fields at 1e-8
max|ref|, save times and fixed-point counts equal, the XDMF text the JAX
writer's, the plot written."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_examples_check as chk  # noqa: E402
from torch_examples_check import one_torch_thread  # noqa: E402,F401
import torch_port_configs as cfg  # noqa: E402


def test_thermomechanics_cavern_on_standin(tmp_path, one_torch_thread):
    import safeincave_torch as st
    grid = cfg.example_kwargs(st, "tm_cavern", {}, str(tmp_path / "grid"))
    _, rec, out = chk.run_twin("tm_cavern", tmp_path, **grid)
    ref = chk.golden_record("tm_cavern", "cpu")
    chk.hold(rec, ref)
    chk.hold_xdmf(out, rec=ref, tmp=tmp_path)
    chk.plot("tm_cavern", tmp_path)
