"""PyTorch port vs JAX package: checkpoints and resume.

On ``torch_port_configs.small_box`` with Kelvin-Voigt + creep (the
Kelvin-Voigt rate depends on theta * t, so re-initialising the rates on
resume would break continuation):

- a port run resumed from its own checkpoint equals the straight run
  bitwise (the checkpoint carries ``u_last_step``, the displacement the
  next step's Krylov initial guess extrapolates from);
- a checkpoint written by the JAX package, loaded into the port, continues
  to the JAX straight run's fields within 1e-10 of max|ref|, and the
  reverse: a port checkpoint continued by the JAX package reaches the
  port's straight run;
- the port writes the JAX package's keys plus ``u_last_step``.
"""
import numpy as np
import pytest
import torch

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg

torch.set_num_threads(1)

FIELDS = ("u", "sig_v", "eps_tot_v")


def _eq(pkg):
    return cfg.small_box(pkg, "cpu", kelvin=True, top=8e6)


def _tc(pkg, hours):
    return pkg.TimeController(dt=1.0, initial_time=0.0, final_time=hours,
                              time_unit="hour")


def _run(pkg, eq, tc, elastic=True):
    pkg.Simulator_M(eq, tc, outputs=[],
                    compute_elastic_response=elastic).run()
    return eq


def _resumed(pkg, path):
    """A fresh equation of ``pkg`` loaded from ``path``, run to 4 h."""
    eq, tc = _eq(pkg), _tc(pkg, 4.0)
    pkg.load_checkpoint(path, eq, tc)
    assert tc.step_counter == 2
    return _run(pkg, eq, tc, elastic=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Straight 4 h runs and 2 h checkpoints of both packages."""
    root = tmp_path_factory.mktemp("ck")
    out = {}
    for pkg in (st, sc):
        straight = _run(pkg, _eq(pkg), _tc(pkg, 4.0))
        tc = _tc(pkg, 2.0)
        half = _run(pkg, _eq(pkg), tc)
        path = str(root / f"{pkg.__name__}.npz")
        pkg.save_checkpoint(path, half, tc)
        out[pkg.__name__] = (straight, path)
    return out


def _close(eq, ref, tol):
    for name in FIELDS:
        got, want = cfg.as_np(getattr(eq, name)), cfg.as_np(getattr(ref,
                                                                     name))
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), name


def test_port_resume_is_bitwise(runs):
    straight, path = runs["safeincave_torch"]
    resumed = _resumed(st, path)
    for name in FIELDS:
        assert torch.equal(getattr(resumed, name), getattr(straight, name))
    for a, b in zip(resumed.mat.elems_ne, straight.mat.elems_ne):
        assert a.state.keys() == b.state.keys()
        for k in a.state:
            assert torch.equal(a.state[k], b.state[k]), k


def test_jax_checkpoint_continues_in_port(runs):
    ref, path = runs["safeincave_tpu"]
    _close(_resumed(st, path), ref, 1e-10)


def test_port_checkpoint_continues_in_jax(runs):
    ref, path = runs["safeincave_torch"]
    _close(_resumed(sc, path), ref, 1e-10)


def test_checkpoint_keys_match_jax(runs):
    port = set(np.load(runs["safeincave_torch"][1]).files)
    jax = set(np.load(runs["safeincave_tpu"][1]).files)
    assert port - jax == {"u_last_step"}
    assert jax <= port


def test_periodic_checkpoint_and_extras(tmp_path):
    """``checkpoint_every`` writes during the run; ``extra`` entries come
    back from load_checkpoint with the prefix stripped."""
    path = str(tmp_path / "auto.npz")
    eq, tc = _eq(st), _tc(st, 2.0)
    st.Simulator_M(eq, tc, [], checkpoint_every=1,
                   checkpoint_path=path).run()
    with np.load(path) as z:
        assert int(z["tc_step"]) == 2
    st.save_checkpoint(path, eq, tc, extra={"note": np.arange(3)})
    extra = st.load_checkpoint(path, _eq(st), _tc(st, 4.0))
    np.testing.assert_array_equal(extra["note"], np.arange(3))
