"""PyTorch port vs JAX package: the JSON driver.

``Simulator_GUI(cfg, device="cpu")`` runs tests/test_output_config.py's
two-stage case (``torch_port_configs.box_case`` on a 2x2x2 box written with
``write_msh``); both stages' outputs, read back with the JAX package's
``postproc``, have the JAX ``Simulator_GUI``'s times and fields within 1e-9
of max|ref|.  ``sim_cli`` runs the same file; the element kinds that are not
ported raise ``NotImplementedError``; without a device argument and without
CUDA both entry points raise.
"""
import os

import numpy as np
import pytest
import torch

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_tpu import postproc
from safeincave_torch.app import sim_cli

torch.set_num_threads(1)

STAGES = {"equilibrium": ("u", "p_elems"),
          "operation": ("u", "p_elems", "q_elems")}


def _case(root, name):
    grid_dir = root / "grid"
    grid_dir.mkdir(exist_ok=True)
    st.mesh.write_msh(str(grid_dir / "geom.msh"),
                      *st.mesh.box_mesh(nx=2, ny=2, nz=2))
    return cfg.box_case(grid_dir, root / name)


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("json")
    st.Simulator_GUI(_case(root, "port"), device="cpu").run()
    sc.Simulator_GUI(_case(root, "jax")).run()
    return root


@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_outputs_match_jax(outputs, stage):
    for field in STAGES[stage]:
        t_ref, ref, _, _ = postproc.read_timeseries(
            str(outputs / "jax" / stage), field)
        t, got, _, _ = postproc.read_timeseries(
            str(outputs / "port" / stage), field)
        np.testing.assert_array_equal(t, t_ref)
        assert got.shape == ref.shape and ref.shape[0] >= 2
        for k in range(ref.shape[0]):
            scale = np.abs(ref[k]).max()
            assert np.abs(got[k] - ref[k]).max() <= 1e-9 * scale, (field, k)


def test_sim_cli_runs_on_cpu(tmp_path):
    path = str(tmp_path / "case.json")
    st.Utils.save_json(_case(tmp_path, "cli"), path)
    sim = sim_cli.main(["--json", path, "--device", "cpu"])
    assert sim.mom_eq.device.type == "cpu"
    t, u, _, _ = st.PostProcessingTools.read_timeseries(
        str(tmp_path / "cli" / "operation"), "u")
    assert u.shape[0] == 5 and np.isfinite(u).all()
    np.testing.assert_array_equal(t, cfg.HOUR * np.arange(5))


@pytest.mark.parametrize("kind", ["PressureSolutionCreep",
                                  "MunsonDawsonCreep",
                                  "MohrCoulombViscoplastic",
                                  "MatsuokaNakaiViscoplastic"])
def test_unported_kinds_raise(tmp_path, kind):
    case = _case(tmp_path, "out")
    case["constitutive_model"]["nonelastic"] = {
        "x": {"type": kind, "active": True, "equilibrium": True,
              "parameters": {}}}
    sim = st.Simulator_GUI(case, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sim.run_equilibrium()


def test_no_device_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = _case(tmp_path, "out")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        st.Simulator_GUI(case)
    path = str(tmp_path / "case.json")
    st.Utils.save_json(case, path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sim_cli.main(["--json", path])
    assert not os.path.exists(tmp_path / "out")
