"""The MaterialCalibration twins on the port, on the CPU, against the JAX
scripts' forward models and sc.calibrate on the same observed records: the
fitted parameters at 1e-8 relative, the forward models at 1e-12 max|ref|.
The twins draw their synthetic noise from a seeded torch.Generator, so the
JAX fits here take the twin's records."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_port_configs as cfg  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")
from torch_examples_check import one_torch_thread  # noqa: E402,F401

TRUE_TRIAX = {"cohesion": 3.0, "friction": np.radians(30.0)}


def _both(name):
    script = cfg.CALIBRATIONS[name]
    return (cfg.load_example("safeincave_tpu", script),
            cfg.load_example("safeincave_torch", script))


def _same_fit(got, want, tol=1e-8):
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= tol * abs(
            float(want[k])), (k, float(got[k]), float(want[k]))


def _jax_fit(model, params0, observed, **kw):
    import safeincave_tpu as sc
    fitted, _ = sc.calibrate(model, params0=params0, observed=observed,
                             loss_scale=float(np.abs(observed).max()), **kw)
    return fitted


def test_creep_twin_main():
    jx, tw = _both("creep")
    fitted = tw["main"](device="cpu")
    obs = tw["observed_record"]("cpu")
    _same_fit(fitted, _jax_fit(jx["axial_creep_strain"],
                               {"A": 5e-20, "n": 2.5}, obs, lr=0.05,
                               steps=300))


def test_labdata_twin_main(tmp_path):
    jx, tw = _both("labdata")
    import matplotlib
    matplotlib.use("Agg")
    out = tw["main"](argv=["--out", str(tmp_path)], device="cpu")
    assert os.path.isfile(tmp_path / "fitted_params.json")
    assert os.path.isfile(tmp_path / "calibration_labdata.png")
    rec = jx["load_ifg_creep_csv"](os.path.join(
        cfg.EXAMPLE_TREES["safeincave_tpu"], "mechanics",
        "MaterialCalibration", "data", "ZW_TCC4.csv"))
    obs = rec["eps_axial"] - rec["eps_axial"][0]
    _same_fit(out["fitted"], _jax_fit(
        jx["make_forward"](rec), {"A": 1e-36, "n": 4.0, "eta1": 1e14,
                                  "E1": 5e9}, obs, lr=0.08, steps=400))


def test_triaxial_twin_forward():
    """The Mohr-Coulomb triaxial twin's curves (one run_compression of two
    confinements, 81 times) against the JAX script's; the fit runs on the
    card in chip_smoke.py's phase 17 (one Adam step here costs ~10 s)."""
    jx, tw = _both("triaxial_fit")
    want = np.asarray(jx["run_twin"](TRUE_TRIAX["cohesion"],
                                     TRUE_TRIAX["friction"]))
    got = tw["run_twin"](TRUE_TRIAX["cohesion"], TRUE_TRIAX["friction"],
                         device="cpu").numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("model", ["sic_axial_strain", "md_axial_strain"])
def test_multimodel_forward_models(model):
    import jax.numpy as jnp
    import torch
    jx, tw = _both("multimodel")
    t_s, s1, s3, _ = jx["staged_schedule"]()
    true = jx["TRUE_SIC"] if model.startswith("sic") else jx["TRUE_MD"]
    want = np.asarray(jx[model]({k: jnp.asarray(v) for k, v in true.items()},
                                t_s, s1, s3))
    got = tw[model]({k: torch.tensor(v, dtype=torch.float64)
                     for k, v in true.items()}, t_s, s1, s3).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_multimodel_twin_main():
    """Both fits at the card's Adam steps against the golden (the JAX fits
    on the twin's records), the records included."""
    _, tw = _both("multimodel")
    sic, md = tw["main"](steps=cfg.MULTIMODEL_STEPS, device="cpu")
    with np.load(os.path.join(os.path.dirname(__file__), "golden",
                              "torch_port_examples_multimodel.npz")) as z:
        t_s, s1, s3, _ = tw["staged_schedule"]()
        obs = np.stack(tw["observed_records"](t_s, s1, s3, "cpu"))
        assert np.abs(obs - z["observed"]).max() <= 1e-15 * np.abs(
            z["observed"]).max()
        _same_fit(sic, {k[len("sic.fit."):]: z[k] for k in z.files
                        if k.startswith("sic.fit.")})
        _same_fit(md, {k[len("md.fit."):]: z[k] for k in z.files
                       if k.startswith("md.fit.")})
