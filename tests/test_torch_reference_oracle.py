"""PyTorch port vs the original SafeInCave stack's frozen oracle.

tests/files/expected_values_equations/expected_values.json holds fields
that the original stack (dolfin + torch) computed on the two-region
cube_coarse mesh; tests/test_reference_oracle.py holds the JAX package to
them.  These are that file's five checks on the port (``device="cpu"``,
one torch thread, pinned as chip_smoke.py's gate pins it), at its
tolerances, on sorted magnitudes (dolfin's node order is not
recoverable):

- the mesh counts;
- the elastic response u_0 (5e-7) and its total strain eps_tot_0 (5e-6);
- Desai's initial hardening alpha_0, and alpha_1, which the oracle kept
  frozen over its first step (2e-6);
- one nonlinear step: u_1 (5e-7), eps_tot_1 (5e-6), and u_1 more than 1.0
  away from u_0.

Beside them, the port against the JAX package on the same mesh in the same
node order: u, the total strain and alpha after the elastic response and
after the step at 1e-8 of max|ref|, and the same iteration count;
tests/golden/torch_port_oracle_cube.npz (what chip_smoke.py holds the card
to) against the live JAX run; and ``torch_port_configs.oracle_cube``'s JAX
branch against the JAX file's own set-up, bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from test_reference_oracle import setup as jax_oracle_setup  # noqa: F401

torch.set_num_threads(1)

RTOL = 1e-8     # the port against the JAX package, of max|ref|
GOLDEN = os.path.join(cfg.ROOT, "tests", "golden",
                      "torch_port_oracle_cube.npz")


@pytest.fixture(scope="module")
def oracle():
    with open(cfg.ORACLE) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def port():
    return cfg.oracle_run(st, "cpu", pin=True)


@pytest.fixture(scope="module")
def jax_run():
    return cfg.oracle_run(sc)


def _check(run, oracle, key):
    tol = {k: t for k, _, t in cfg.ORACLE_CHECKS}[key]
    rel = cfg.oracle_distance(run, oracle, key)
    assert rel < tol, (key, rel)


def test_mesh_counts(oracle):
    grid = st.GridHandlerGMSH("geom", cfg.CUBE_COARSE)
    assert 3 * grid.n_nodes == len(oracle["u_0"])
    assert grid.n_elems == len(oracle["alpha_0"])


def test_elastic_field_parity(port, oracle):
    _check(port, oracle, "u_0")


def test_elastic_strain_parity(port, oracle):
    """The oracle froze the elastic response's total strain as a
    9-component tensor per element (each shear twice)."""
    _check(port, oracle, "eps_tot_0")


def test_initial_hardening_parity(port, oracle):
    _check(port, oracle, "alpha_0")
    _check(port, oracle, "alpha_1")


def test_one_step_trajectory_parity(port, oracle):
    assert port["error"] < 1e-9, (port["iterations"], port["error"])
    _check(port, oracle, "u_1")
    _check(port, oracle, "eps_tot_1")
    # and it is not the elastic field, which is ~9x off
    assert cfg.sorted_rel(port["u_step"], oracle["u_0"]) > 1.0


@pytest.mark.parametrize("when", ["elastic", "step"])
def test_unsorted_fields_match_jax(when, port, jax_run):
    """Both packages number the nodes alike, so u, the total strain and
    alpha are compared entry for entry; the step takes as many
    iterations."""
    for name in ("u", "eps", "alpha"):
        key = f"{name}_{when}"
        got, want = port[key], jax_run[key]
        assert got.shape == want.shape, key
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= RTOL, (key, rel)
    assert port["iterations"] == jax_run["iterations"]


def test_golden_is_the_jax_run(jax_run):
    """tests/golden/torch_port_oracle_cube.npz, which the card is held
    to, is this JAX run (regenerate with
    ``python tests/generate_torch_port_golden.py oracle_cube``)."""
    with np.load(GOLDEN) as z:
        assert sorted(z.files) == sorted(jax_run)
        for k in z.files:
            want = jax_run[k]
            scale = max(np.abs(want).max(), 1e-300)
            assert np.abs(z[k] - want).max() <= 1e-12 * scale, k


def test_builder_equals_the_jax_oracle_setup(jax_oracle_setup):  # noqa: F811
    """``oracle_cube``'s JAX branch builds tests/test_reference_oracle.py's
    problem: the material, the boundary tables, the solver settings, the
    temperatures, the body force and the elastic response, bit for bit."""
    ref_eq, _ = jax_oracle_setup
    eq, _ = cfg.oracle_cube(sc)
    got, ref = cfg.setup_arrays(eq), cfg.setup_arrays(ref_eq)
    assert sorted(got) == sorted(ref)
    for table in ("bc._dirichlet_meta.", "bc._neumann_meta.",
                  "mat.elems_ne.2.", "solver.precond"):
        assert any(k.startswith(table) for k in got), table
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for name in ("u", "sig_v"):
        np.testing.assert_array_equal(cfg.as_np(getattr(eq, name)),
                                      cfg.as_np(getattr(ref_eq, name)),
                                      err_msg=name)
