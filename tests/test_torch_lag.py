"""PyTorch port vs JAX package: tangent lagging and adaptive inner
tolerances with the loose-mode rollback.

The bench's material (Desai included) and loads on a band-ordered box,
``precond="2level"`` and ``fp32_phase=False`` pinned on both sides.  With
the same flag on both packages the fields agree at 1e-8 relative and the
fixed-point and tangent-build counts are equal; the JAX package's builds
are counted by a callback placed in front of its ``f_tangent_all`` (only
the branch a ``lax.cond`` takes runs on the CPU).  Against its own default
path the port's lagged and adaptive fields agree at 2e-7 of max|ref|, the
bound the JAX package's own tests use.
"""
import numpy as np
import pytest
import torch
import jax

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_tpu.mesh.reorder import reordered_grid as jax_reordered
from safeincave_torch.mesh.reorder import reordered_grid

torch.set_num_threads(1)

DT = cfg.HOUR
N_STEPS = 4
TS = [(k + 1) * DT for k in range(N_STEPS)]
FIELDS = ("u", "sig_v", "eps_tot_v")
MODES = {"default": {}, "lag": {"lag_tangent": True},
         "adaptive": {"adaptive_rtol": True}}


def _wire(pkg, flags, nx=4, **settings):
    reorder = reordered_grid if pkg is st else jax_reordered
    box = pkg.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=nx, ny=nx, nz=nx)
    grid = reorder(box, method="band")[0]
    eq = cfg.wire_bench(pkg, grid, device="cpu")
    eq.set_solver(pkg.SolverSettings(precond="2level", fp32_phase=False,
                                     **{**cfg.SETTINGS, **settings}, **flags))
    cfg.elastic_init(eq)
    return eq


def _fields(eq):
    return {k: cfg.as_np(getattr(eq, k)) for k in FIELDS}


def _count_jax_builds(eq):
    """Count executions of ``eq.mat.f_tangent_all`` inside the jitted step."""
    n = [0]
    inner = eq.mat.f_tangent_all

    def counted(*args):
        jax.debug.callback(lambda: n.__setitem__(0, n[0] + 1))
        return inner(*args)

    eq.mat.f_tangent_all = counted
    return n


@pytest.fixture(scope="module")
def port_runs():
    """mode -> (equation, stats rows) of the port after N_STEPS fused
    steps."""
    out = {}
    for mode, flags in MODES.items():
        eq = _wire(st, flags)
        out[mode] = (eq, eq.solve_time_steps(TS, [DT] * N_STEPS, tol=1e-8,
                                             maxiter=40))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_flag_matches_jax(port_runs, mode):
    eq_p, rows_p = port_runs[mode]
    eq_j = _wire(sc, MODES[mode])
    builds = _count_jax_builds(eq_j)
    rows_j = np.asarray(eq_j.solve_time_steps(TS, [DT] * N_STEPS, tol=1e-8,
                                              maxiter=40))
    jax.effects_barrier()
    assert (rows_p[:, 5] == 1).all() and (rows_j[:, 5] == 1).all()
    np.testing.assert_array_equal(rows_p[:, 0], rows_j[:, 0])
    assert eq_p.tangent_builds_total == builds[0]
    assert eq_p.fp_iterations_total == int(rows_p[:, 0].sum())
    fj = _fields(eq_j)
    for k, got in _fields(eq_p).items():
        np.testing.assert_allclose(got, fj[k], rtol=1e-8,
                                   atol=1e-8 * np.abs(fj[k]).max(),
                                   err_msg=f"{mode}: {k}")
    # committed inelastic strains, against the largest mechanism's scale
    # (the Desai element is below yield here: its strain is rounding noise)
    scale = max(np.abs(np.asarray(e.state["eps_old"])).max()
                for e in eq_j.mat.elems_ne)
    for e_p, e_j in zip(eq_p.mat.elems_ne, eq_j.mat.elems_ne):
        np.testing.assert_allclose(e_p.state["eps_old"].numpy(),
                                   np.asarray(e_j.state["eps_old"]),
                                   rtol=1e-8, atol=1e-8 * scale,
                                   err_msg=e_p.name)
    np.testing.assert_allclose(
        eq_p.mat.elems_ne[-1].state["alpha"].numpy(),
        np.asarray(eq_j.mat.elems_ne[-1].state["alpha"]), rtol=1e-8)


@pytest.mark.parametrize("mode", ["lag", "adaptive"])
def test_mode_tracks_default_path(port_runs, mode):
    """The flags shape the iteration path, not the fixed point."""
    ref = _fields(port_runs["default"][0])
    eq, rows = port_runs[mode]
    assert (rows[:, 5] == 1).all()
    for k, got in _fields(eq).items():
        np.testing.assert_allclose(got, ref[k], rtol=0,
                                   atol=2e-7 * np.abs(ref[k]).max(),
                                   err_msg=k)
    a = eq.mat.elems_ne[-1].state["alpha"].numpy()
    b = port_runs["default"][0].mat.elems_ne[-1].state["alpha"].numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5)


def test_lag_skips_builds_and_default_builds_every_iteration(port_runs):
    eq_d, rows_d = port_runs["default"]
    assert eq_d.tangent_builds_total == int(rows_d[:, 0].sum())
    assert eq_d.rollbacks_total == 0
    eq_l, rows_l = port_runs["lag"]
    assert eq_l.tangent_builds_total < int(rows_l[:, 0].sum())
    assert eq_l.rollbacks_total == 0
    # convergence is declared on a fresh tangent: at least two builds a step
    assert eq_l.tangent_builds_total >= 2 * N_STEPS


def test_flags_off_is_bitwise_the_always_fresh_loop():
    """Both flags off: the loop is the one it was before the flags existed.
    A lagged run whose every iteration must rebuild (tol so large that the
    first error is already within 10 tol) walks the same path bit for
    bit."""
    eq_a = _wire(st, {})
    eq_b = _wire(st, {"lag_tangent": True})
    for eq in (eq_a, eq_b):
        ite, err = eq.solve_time_step(DT, DT, tol=0.5, maxiter=40)
        assert ite >= 1 and err <= 0.5
    assert eq_b.tangent_builds == eq_b.fp_iterations_total
    for k in FIELDS:
        assert torch.equal(getattr(eq_a, k), getattr(eq_b, k)), k


@pytest.mark.parametrize("driver", ["step", "steps"])
def test_forced_rollback_returns_to_entry_state(driver):
    """A loose solve that stalls (two Krylov iterations per pass cannot
    reach its target) rolls the step back to its entry state bit for bit
    and continues tight-only; the tight solve then stalls too and fails the
    step, which leaves the entry state in place."""
    eq = _wire(st, {"adaptive_rtol": True}, max_it=2, max_passes=1)
    entry = {k: getattr(eq, k).clone() for k in FIELDS}
    states = [{k: v.clone() for k, v in e.state.items()}
              for e in eq.mat.elems_ne]
    if driver == "step":
        ite, err = eq.solve_time_step(DT, DT, tol=1e-8, maxiter=1)
        assert err == 1.0 and ite == 1
        # maxiter=1: the loop ends right after the rollback
        for k in FIELDS:
            assert torch.equal(getattr(eq, k), entry[k]), k
        for e, old in zip(eq.mat.elems_ne, states):
            for key, v in old.items():
                assert torch.equal(e.state[key], v), key
        assert eq.rollbacks == 1 and eq.tangent_builds == 1
    else:
        rows = eq.solve_time_steps([DT, 2 * DT], [DT, DT], tol=1e-8,
                                   maxiter=40)
        assert rows[0, 5] == 0 and rows[1].tolist() == [0, 1, 0, 0, 0, 0]
        assert eq.rollbacks_total == 1
        for k in FIELDS:
            assert torch.equal(getattr(eq, k), entry[k]), k
        for e, old in zip(eq.mat.elems_ne, states):
            for key, v in old.items():
                assert torch.equal(e.state[key], v), key


def test_flags_run_in_the_coupled_driver():
    """``solve_tm_time_steps`` runs the same body: lagged against default on
    the thermo-mechanical cube, fields at 2e-7 and fewer tangent builds."""
    out = {}
    for mode in ("default", "lag", "adaptive"):
        eq, heat = cfg.tm_cube(st, device="cpu")
        eq.set_solver(st.SolverSettings(method="bicgstab", rtol=1e-12,
                                        max_it=500, **MODES[mode]))
        cfg.tm_start(eq, heat)
        rows = eq.solve_tm_time_steps(heat, [DT, 2 * DT, 3 * DT], [DT] * 3,
                                      tol=1e-8, maxiter=30)
        assert (rows[:, 5] == 1).all()
        out[mode] = (eq, rows)
    ref = _fields(out["default"][0])
    for mode in ("lag", "adaptive"):
        for k, got in _fields(out[mode][0]).items():
            np.testing.assert_allclose(got, ref[k], rtol=0,
                                       atol=2e-7 * np.abs(ref[k]).max())
    assert (out["lag"][0].tangent_builds_total
            <= out["lag"][0].fp_iterations_total)
