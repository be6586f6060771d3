"""PyTorch port vs JAX package: the thermo-mechanical path.

The same numpy inputs go through both packages, every port object on
``device="cpu"``:

- ``Thermoelastic`` in float64 (1e-12) and float32 (1e-6);
- the thermal strain in the momentum fixed point: ``solve_time_step`` with
  ``Temp = T0 + 10 K`` (on average) agrees with the JAX package at 1e-9 of max|ref|, and
  differs by far more when the term is dropped (what the port computed
  before it carried ``eps_th``);
- ``Material.compute_G_B`` / ``compute_CT`` at 1e-10;
- ``tm_u``, ``tm_sig`` and ``tm_T`` of tests/golden/fields.npz (the JAX
  package's coupled cube) reproduced at 1e-8;
- ``solve_tm_time_steps``: rows and fields against the JAX package at 1e-9,
  the per-step flow and the fused chunk agree, and a forced failure leaves
  both equations at the failed step's entry state bit for bit;
- ``solve_tm_time_steps`` with a heat field that stays at ``T0`` and no
  thermoelastic element equals ``solve_time_steps`` on a twin equation
  (1e-12, equal fixed-point and Krylov counts): one step loop serves both;
- ``Simulator_TM`` in the per-step flow and in fused chunks against the JAX
  driver (u and T outputs read back, 1e-9), a poisoned step recovered by
  the dt-halving retry with the heat field restored, and a step that always
  fails ending at the entry state with no commit and no diagnostic dump;
- checkpoints with the heat keys: a bitwise port resume, JAX -> port and
  port -> JAX at 1e-10;
- a Mohr-Coulomb + Thermoelastic coupled cube over 3 steps at 1e-8;
- the f32 sweep with the thermal strain against the float64 path.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_tpu import postproc
from safeincave_torch import interop

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
HOUR = cfg.HOUR
FIELDS = ("u", "sig_v", "eps_tot_v")


def _close(got, want, rtol, what):
    got, want = cfg.as_np(got), cfg.as_np(want)
    scale = max(np.abs(want).max(), 1e-300)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= rtol * scale, \
        (what, np.abs(got - want).max() / scale)


def _close_eqs(got, ref, tol, heats=None):
    for name in FIELDS:
        _close(getattr(got, name), getattr(ref, name), tol, name)
    for a, b in zip(got.mat.elems_ne, ref.mat.elems_ne):
        for k in ("eps_old", "rate_old"):
            _close(a.state[k], b.state[k], max(tol, 1e-9), f"{a.name} {k}")
    if heats:
        _close(heats[0].T, heats[1].T, tol, "T")


# --------------------------------------------------------------------------- #
# Thermoelastic and the thermal strain of the fixed point
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,tol", [("f64", 1e-12), ("f32", 1e-6)])
def test_thermoelastic(dtype, tol):
    rng = np.random.default_rng(0)
    alpha = 44e-6 * rng.uniform(0.5, 2.0, 32)
    dT = 15.0 * rng.normal(size=32)
    tj, tp = sc.Thermoelastic(alpha), st.Thermoelastic(alpha, device="cpu")
    jt, tt = (jnp.float64, torch.float64) if dtype == "f64" else \
        (jnp.float32, torch.float32)
    want = tj.eps_th_voigt(jnp.asarray(dT, jt))
    got = tp.eps_th_voigt(torch.as_tensor(dT, dtype=tt))
    assert got.dtype == tt and got.shape == (32, 6)
    assert np.asarray(want).dtype == (np.float64 if dtype == "f64"
                                      else np.float32)
    _close(got, want, tol, "eps_th")
    assert float(got[:, 3:].abs().max()) == 0.0
    tj.compute_eps_th(dT)
    tp.compute_eps_th(dT)
    _close(tp.eps_th, tj.eps_th, 1e-12, "eps_th tensor")
    assert tp.eps_th.shape == (32, 3, 3)


def _heated_step(pkg, drop_eps_th=False):
    """One ``solve_time_step`` of the coupled cube's momentum equation with
    the elements 10 K above T0 on average (5 to 15 K, drawn from a seed: a
    uniform rise expands the cube freely and leaves no thermal stress)."""
    eq, heat = cfg.tm_cube(pkg, "cpu")
    cfg.tm_start(eq, heat)
    rise = 10.0 * np.random.default_rng(5).uniform(0.5, 1.5, eq.n_elems)
    eq.set_T(cfg.as_np(eq.T0) + rise)
    if drop_eps_th:
        eq.compute_eps_th = lambda: None
    ite, err = eq.solve_time_step(HOUR, HOUR, tol=1e-9, maxiter=40)
    assert err <= 1e-9
    return eq


def test_eps_th_repair_solve_time_step_matches_jax():
    ref, got = _heated_step(sc), _heated_step(st)
    _close(got.u, ref.u, 1e-9, "u")
    _close(got.sig_v, ref.sig_v, 1e-9, "sig_v")
    old = _heated_step(st, drop_eps_th=True)
    du = np.abs(cfg.as_np(old.u) - cfg.as_np(ref.u)).max()
    assert du > 0.1 * np.abs(cfg.as_np(ref.u)).max(), du
    ds = np.abs(cfg.as_np(old.sig_v) - cfg.as_np(ref.sig_v)).max()
    assert ds > 1e5, ds          # Pa: the thermal stress the old code lost


def test_no_thermoelastic_element_no_thermal_term():
    """Without a thermoelastic element the fixed point is handed no thermal
    strain at all (not a zero array), whatever Temp - T0 is: the mechanics
    paths compute what they did before the coupling."""
    eq = cfg.small_box(st, "cpu")
    assert eq.mat.elems_th == [] and eq.compute_eps_th() is None
    cfg.elastic_init(eq)
    seen = []
    real = eq._fixed_point

    def spy(*args, **kw):
        seen.append(kw.get("eps_th", "absent"))
        return real(*args, **kw)
    eq._fixed_point = spy
    eq.set_T(cfg.as_np(eq.T0) + 10.0)
    eq.solve_time_step(HOUR, HOUR)
    eq.solve_time_steps([2 * HOUR], [HOUR])
    assert seen == [None, None]


def test_compute_eps_th_sums_elements():
    eq, _ = cfg.tm_cube(st, "cpu")
    one = np.ones(eq.n_elems)
    eq.mat.add_to_thermoelastic(st.Thermoelastic(1e-5 * one, device="cpu"))
    eq.set_T0(298.0 * one)
    eq.set_T(308.0 * one)
    want = (4.4e-5 + 1e-5) * 10.0
    got = eq.compute_eps_th()
    np.testing.assert_allclose(got[:, :3].numpy(), want, rtol=1e-14)
    assert float(got[:, 3:].abs().max()) == 0.0


def test_material_compute_G_B_and_CT_match_jax():
    """The reference-style mutating helpers of ``Material`` on the coupled
    cube's material after the elastic response."""
    out = {}
    for pkg in (sc, st):
        eq, heat = cfg.tm_cube(pkg, "cpu")
        cfg.tm_start(eq, heat)
        eq.mat.compute_G_B(eq.sig_v, HOUR, 0.5, eq.Temp)
        eq.mat.compute_CT(HOUR, 0.5)
        out[pkg.__name__] = eq.mat
    mj, mp = out["safeincave_tpu"], out["safeincave_torch"]
    for name in ("G", "B6", "CT"):
        _close(getattr(mp, name), getattr(mj, name), 1e-10, name)
    for a, b in zip(mp.elems_ne, mj.elems_ne):
        _close(a.state["G"], b.state["G"], 1e-10, f"{a.name} G")


# --------------------------------------------------------------------------- #
# the coupled cube: golden, fused driver, failure
# --------------------------------------------------------------------------- #
def test_tm_cube_reproduces_jax_golden():
    eq, heat = cfg.tm_cube(st, "cpu")
    rows = cfg.run_tm_steps(eq, heat)
    assert (rows[:, 1] <= 1e-6).all()
    with np.load(os.path.join(HERE, "golden", "fields.npz")) as z:
        _close(eq.u, z["tm_u"], 1e-8, "tm_u")
        _close(eq.sig_v, z["tm_sig"], 1e-8, "tm_sig")
        _close(heat.T, z["tm_T"], 1e-8, "tm_T")


def _fused(pkg, n_steps=4, **kw):
    eq, heat = cfg.tm_cube(pkg, "cpu", **kw)
    cfg.tm_start(eq, heat)
    rows = eq.solve_tm_time_steps(heat, [(k + 1) * HOUR
                                         for k in range(n_steps)],
                                  [HOUR] * n_steps, tol=1e-6, maxiter=20)
    return eq, heat, np.asarray(rows)


@pytest.fixture(scope="module")
def fused_runs():
    return {pkg.__name__: _fused(pkg) for pkg in (sc, st)}


def test_solve_tm_time_steps_matches_jax(fused_runs):
    ej, hj, rj = fused_runs["safeincave_tpu"]
    ep, hp, rp = fused_runs["safeincave_torch"]
    assert rp.shape == rj.shape == (4, 6)
    # fixed-point iterations and converged flags equal, errors close; the
    # heat CG and Krylov counts (columns 0, 4) may differ in f32 rounding
    np.testing.assert_array_equal(rp[:, [2, 5]], rj[:, [2, 5]])
    assert (rp[:, 5] == 1).all() and (rp[:, 0] > 0).all()
    np.testing.assert_allclose(rp[:, 3], rj[:, 3], rtol=1e-3, atol=1e-12)
    _close_eqs(ep, ej, 1e-9, (hp, hj))
    _close(ep.Temp, ej.Temp, 1e-12, "Temp")
    _close(ep._u_last_step, ej._u_last_step, 1e-9, "u_last_step")
    assert hp.solver_stats == (int(rp[-1, 0]), float(rp[-1, 1]))
    assert ep.krylov_total == int(rp[-1, 4])
    assert hp.T is hp.T_old


def test_fused_tm_equals_per_step_flow(fused_runs):
    """The chunk and the per-step flow with the commit calls give the same
    state (the JAX package holds its own pair to 1e-9)."""
    ep, hp, rp = fused_runs["safeincave_torch"]
    eq, heat = cfg.tm_cube(st, "cpu")
    rows = cfg.run_tm_steps(eq, heat, n_steps=4)
    np.testing.assert_array_equal(rows[:, 0], rp[:, 2])
    _close_eqs(eq, ep, 1e-12, (heat, hp))


def _snapshot(eq, heat):
    return ([getattr(eq, k).clone() for k in FIELDS + ("Temp",)],
            [{k: v.clone() for k, v in e.state.items()}
             for e in eq.mat.elems_ne], heat.T.clone(), heat.T_old.clone())


def _assert_bitwise(eq, heat, snap):
    fields, states, T, T_old = snap
    for k, want in zip(FIELDS + ("Temp",), fields):
        assert torch.equal(getattr(eq, k), want), k
    for e, st_ in zip(eq.mat.elems_ne, states):
        assert e.state.keys() == st_.keys()
        for k, v in st_.items():
            assert torch.equal(e.state[k], v), (e.name, k)
    assert torch.equal(heat.T, T) and torch.equal(heat.T_old, T_old)


def test_failed_tm_step_leaves_entry_state():
    """The third step of a chunk of four fails (its error is forced to
    NaN): two rows converged, the failed row carries its heat and
    fixed-point counts, the last row did not run, and the momentum and heat
    equations hold the state after step 2 bit for bit, which is what a run
    of two steps leaves."""
    eq, heat = cfg.tm_cube(st, "cpu")
    cfg.tm_start(eq, heat)
    real, calls = eq._fixed_point, {"n": 0}

    def fixed_point(*args, **kw):
        calls["n"] += 1
        out = real(*args, **kw)
        if calls["n"] == 3:
            # poison what a failed iteration would leave behind
            bad = tuple(x * float("nan") for x in out[1:4])
            out = out[:1] + bad + out[4:6] + (float("nan"),) + out[7:]
        return out
    eq._fixed_point = fixed_point
    rows = eq.solve_tm_time_steps(heat, [(k + 1) * HOUR for k in range(4)],
                                  [HOUR] * 4, tol=1e-6, maxiter=20)
    assert rows[:, 5].tolist() == [1.0, 1.0, 0.0, 0.0]
    assert rows[2, 0] > 0 and rows[2, 2] > 0 and np.isnan(rows[2, 3])
    assert rows[3].tolist() == [0.0, 0.0, 0.0, 1.0, 0.0, 0.0]
    assert calls["n"] == 3

    two, heat2, _ = _fused(st, n_steps=2)
    _assert_bitwise(eq, heat, _snapshot(two, heat2))
    assert torch.equal(eq._u_last_step, two._u_last_step)
    assert heat.solver_stats == (int(rows[1, 0]), float(rows[1, 1]))

    # no step converged: stats say so
    eq._fixed_point = lambda *a, **kw: real(*a, **kw)[:6] + (
        float("inf"),) + real(*a, **kw)[7:]
    snap = _snapshot(eq, heat)
    rows = eq.solve_tm_time_steps(heat, [3 * HOUR], [HOUR])
    assert rows[0, 5] == 0.0 and eq.krylov_total == 0
    assert np.isnan(heat.solver_stats[1])
    _assert_bitwise(eq, heat, snap)


def test_tm_steps_without_heat_load_equal_mechanics_steps():
    """With the heat field held at ``T0`` (a Dirichlet condition at 298 K,
    the box's temperature, and no load) and no thermoelastic element, the
    coupled chunk computes what the mechanics chunk computes on a twin
    equation: the same fields, fixed-point and Krylov counts."""
    eq_m, eq_t = cfg.small_box(st, "cpu"), cfg.small_box(st, "cpu")
    one = np.ones(eq_t.n_elems)
    eq_t.mat.set_specific_heat_capacity(850.0 * one)
    eq_t.mat.set_thermal_conductivity(5.0 * one)
    heat = st.HeatDiffusion(eq_t.grid, device="cpu")
    heat.set_solver(st.SolverSettings(method="cg", rtol=1e-12, max_it=500))
    heat.set_material(eq_t.mat)
    heat.set_initial_T(298.0 * np.ones(eq_t.n_nodes))
    bc = st.HeatBC.BcHandler(heat)
    bc.add_boundary_condition(st.HeatBC.DirichletBC("TOP", [298., 298.],
                                                    [0.0, 1e9]))
    heat.set_boundary_conditions(bc)
    assert eq_t.mat.elems_th == []
    for eq in (eq_m, eq_t):
        cfg.elastic_init(eq)
    ts, dts = [(k + 1) * HOUR for k in range(3)], [HOUR] * 3
    rows_m = eq_m.solve_time_steps(ts, dts, tol=1e-8, maxiter=40)
    rows_t = eq_t.solve_tm_time_steps(heat, ts, dts, tol=1e-8, maxiter=40)
    assert (rows_m[:, 5] == 1).all() and (rows_t[:, 5] == 1).all()
    np.testing.assert_array_equal(rows_t[:, 2], rows_m[:, 0])
    np.testing.assert_array_equal(rows_t[:, 4], rows_m[:, 2])
    assert eq_t.krylov_total == eq_m.krylov_total
    np.testing.assert_allclose(heat.T.numpy(), 298.0, rtol=1e-12)
    _close(eq_t.u, eq_m.u, 1e-12, "u")
    _close(eq_t.sig_v, eq_m.sig_v, 1e-12, "sig_v")


# --------------------------------------------------------------------------- #
# Simulator_TM
# --------------------------------------------------------------------------- #
def _run_sim(pkg, folder, save_every, fused, hours=5.0, extra=None):
    eq, heat = cfg.tm_cube(pkg, "cpu", extra=extra)
    outs = []
    for obj, field in ((eq, "u"), (heat, "T"), (eq, "q_elems")):
        out = pkg.SaveFields(obj, save_every=save_every)
        out.set_output_folder(os.path.join(folder, field))
        out.add_output_field(field, field)
        outs.append(out)
    tc, rows = cfg.run_tm_sim(pkg, eq, heat, outs, hours=hours,
                              fused_steps=fused)
    return eq, heat, rows, tc


@pytest.mark.parametrize("flow", ["per_step", "fused"])
def test_simulator_TM_matches_jax(tmp_path, flow):
    every, fused = (1, 1) if flow == "per_step" else (2, "auto")
    ej, hj, rj, _ = _run_sim(sc, str(tmp_path / "jax"), every, fused)
    ep, hp, rp, tc = _run_sim(st, str(tmp_path / "port"), every, fused)
    assert tc.step_counter == 5 and len(rp) == 5
    np.testing.assert_array_equal(rp[:, 0], rj[:, 0])
    for field in ("u", "T", "q_elems"):
        t_ref, ref, _, _ = postproc.read_timeseries(
            str(tmp_path / "jax" / field), field)
        t, got, _, _ = postproc.read_timeseries(
            str(tmp_path / "port" / field), field)
        np.testing.assert_array_equal(t, t_ref)
        assert len(t) == len(range(0, 6, every))
        for k in range(ref.shape[0]):
            _close(got[k], ref[k], 1e-9, f"{field} save {k}")
    _close_eqs(ep, ej, 1e-9, (hp, hj))
    _close(ep.T0, ej.T0, 1e-14, "T0")


def test_simulator_TM_fused_equals_per_step(tmp_path):
    a, ha, ra, _ = _run_sim(st, str(tmp_path / "a"), 5, 1)
    b, hb, rb, _ = _run_sim(st, str(tmp_path / "b"), 5, "auto")
    np.testing.assert_array_equal(ra[:, 0], rb[:, 0])
    _close_eqs(b, a, 1e-12, (hb, ha))


def test_simulator_TM_chunks_follow_outputs_and_hooks(tmp_path):
    eq, heat = cfg.tm_cube(st, "cpu")
    tc = st.TimeController(dt=1.0, initial_time=0.0, final_time=5.0,
                           time_unit="hour")
    sim = st.Simulator_TM(eq, heat, tc, [])
    assert sim._plan_chunk_size() == 64
    assert st.Simulator_TM(eq, heat, tc, [], fused_steps=1)\
        ._plan_chunk_size() == 1
    out = st.SaveFields(heat, save_every=3)
    out._call_count = 1
    assert st.Simulator_TM(eq, heat, tc, [out])._plan_chunk_size() == 3
    assert st.Simulator_TM(eq, heat, tc, [object()])._plan_chunk_size() == 1
    heat.solve = heat.solve         # an instance-level wrapper of the step
    assert sim._plan_chunk_size() == 1


def test_simulator_TM_retry_recovers_poisoned_step():
    """The second step's first attempt reports NaN and leaves NaN in the
    fields, the states and the heat field: the retry restores all of them
    and converges at dt / 2 to the state of a run whose failed attempt left
    nothing behind."""
    def run(poison):
        eq, heat = cfg.tm_cube(st, "cpu")
        real, calls = eq.solve_time_step, {"n": 0, "dts": []}

        def wrapped(t, dt, tol=1e-8, maxiter=40):
            calls["n"] += 1
            calls["dts"].append(dt)
            if calls["n"] == 2:
                eq._last_sv_k = eq.sig_v
                if poison:
                    nan = float("nan")
                    eq.u, eq.sig_v = eq.u * nan, eq.sig_v * nan
                    eq.eps_tot_v = eq.eps_tot_v * nan
                    heat.T, heat.T_old = heat.T * nan, heat.T_old * nan
                    for e in eq.mat.elems_ne:
                        e.state = {k: v * nan for k, v in e.state.items()}
                return maxiter, float("nan")
            return real(t, dt, tol=tol, maxiter=maxiter)
        eq.solve_time_step = wrapped
        tc = st.TimeController(dt=1.0, initial_time=0.0, final_time=2.0,
                               time_unit="hour")
        st.Simulator_TM(eq, heat, tc, []).run()
        return eq, heat, calls
    eq, heat, calls = run(poison=True)
    clean, clean_heat, _ = run(poison=False)
    assert calls["dts"] == [3600.0, 3600.0, 1800.0]
    assert eq._fp32_disable is False
    assert bool(torch.isfinite(heat.T).all())
    _assert_bitwise(eq, heat, _snapshot(clean, clean_heat))


def test_simulator_TM_exhausted_retries_restore_without_dump(tmp_path,
                                                            monkeypatch):
    """A step whose every attempt reports NaN and poisons the fields, the
    states and the heat field uses up the dt halvings and ends at the entry
    state (the coupled start, as ``tm_start`` runs it) bit for bit: nothing
    committed, and unlike ``Simulator_M`` no ``nan_diagnostic.npz``."""
    monkeypatch.chdir(tmp_path)
    eq, heat = cfg.tm_cube(st, "cpu")
    calls = {"dts": [], "commits": 0}

    def fail(t, dt, tol=1e-8, maxiter=40):
        calls["dts"].append(dt)
        nan = float("nan")
        eq.u, eq.sig_v = eq.u * nan, eq.sig_v * nan
        eq.eps_tot_v, eq._last_sv_k = eq.eps_tot_v * nan, eq.sig_v
        heat.T, heat.T_old = heat.T * nan, heat.T_old * nan
        for e in eq.mat.elems_ne:
            e.state = {k: v * nan for k, v in e.state.items()}
        return maxiter, nan

    def commit(*args, **kw):
        calls["commits"] += 1
    eq.solve_time_step, eq.commit_time_step = fail, commit
    tc = st.TimeController(dt=1.0, initial_time=0.0, final_time=1.0,
                           time_unit="hour")
    sim = st.Simulator_TM(eq, heat, tc, [])
    sim.run()
    assert calls["dts"] == [HOUR / 2 ** k for k in range(sim.max_dt_cuts + 1)]
    assert calls["commits"] == 0 and tc.step_counter == 1
    assert eq._fp32_disable is False
    assert not os.path.exists("nan_diagnostic.npz")
    entry, entry_heat = cfg.tm_cube(st, "cpu")
    cfg.tm_start(entry, entry_heat)
    for k in FIELDS:
        assert torch.equal(getattr(eq, k), getattr(entry, k)), k
    for e, want in zip(eq.mat.elems_ne, entry.mat.elems_ne):
        assert e.state.keys() == want.state.keys()
        for k, v in want.state.items():
            assert torch.equal(e.state[k], v), (e.name, k)
    assert torch.equal(heat.T, entry_heat.T)
    assert torch.equal(heat.T_old, entry_heat.T_old)


# --------------------------------------------------------------------------- #
# checkpoints with the heat keys
# --------------------------------------------------------------------------- #
def _steps(eq, heat, first, n):
    rows = eq.solve_tm_time_steps(heat, [(first + k) * HOUR
                                         for k in range(n)], [HOUR] * n)
    assert (np.asarray(rows)[:, 5] == 1).all()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Straight 4-step runs and 2-step checkpoints of both packages."""
    root = tmp_path_factory.mktemp("tm_ck")
    out = {}
    for pkg in (st, sc):
        straight = _fused(pkg)[:2]
        eq, heat, _ = _fused(pkg, n_steps=2)
        path = str(root / f"{pkg.__name__}.npz")
        pkg.save_checkpoint(path, eq, heat_eq=heat)
        out[pkg.__name__] = (straight, path)
    return out


def _resumed(pkg, path):
    eq, heat = cfg.tm_cube(pkg, "cpu")
    pkg.load_checkpoint(path, eq, heat_eq=heat)
    _steps(eq, heat, 3, 2)
    return eq, heat


def test_tm_checkpoint_port_resume_is_bitwise(checkpoints):
    (straight, heat_s), path = checkpoints["safeincave_torch"]
    with np.load(path) as z:
        assert {"heat_T", "heat_T_old", "T0", "Temp"} <= set(z.files)
    eq, heat = _resumed(st, path)
    _assert_bitwise(eq, heat, _snapshot(straight, heat_s))


def test_tm_checkpoint_jax_to_port(checkpoints):
    (ref, heat_ref), path = checkpoints["safeincave_tpu"]
    eq, heat = _resumed(st, path)
    _close_eqs(eq, ref, 1e-10, (heat, heat_ref))


def test_tm_checkpoint_port_to_jax(checkpoints):
    (ref, heat_ref), path = checkpoints["safeincave_torch"]
    eq, heat = _resumed(sc, path)
    _close_eqs(eq, ref, 1e-10, (heat, heat_ref))


def test_checkpoint_without_heat_equation_keeps_its_keys(tmp_path):
    eq, heat, _ = _fused(st, n_steps=1)
    path = str(tmp_path / "mech.npz")
    st.save_checkpoint(path, eq)
    with np.load(path) as z:
        assert "heat_T" not in z.files
    T = heat.T.clone()
    st.load_checkpoint(path, eq, heat_eq=heat)     # no heat keys: untouched
    assert torch.equal(heat.T, T)


# --------------------------------------------------------------------------- #
# interop, Mohr-Coulomb coupling, the f32 sweep
# --------------------------------------------------------------------------- #
def test_interop_carries_the_thermal_state():
    """A JAX coupled run's state (fields, heat field, thermoelastic alpha,
    thermal properties, every element's state and parameters) loaded onto
    fresh port equations continues like the JAX run."""
    ej, hj, _ = _fused(sc, n_steps=2)
    d = interop.numpy_state(ej, hj)
    assert set(d["heat"]) == {"T", "T_old"} and len(d["thermo"]) == 1
    assert set(d["thermal"]) == {"density", "cp", "k", "alpha_th"}
    d["thermo"][0] = 1.5 * d["thermo"][0]
    d["thermal"]["k"] = 2.0 * d["thermal"]["k"]
    ep, hp = cfg.tm_cube(st, "cpu")
    interop.load_numpy_state(ep, d, hp)
    np.testing.assert_allclose(ep.mat.elems_th[0].alpha.numpy(), 6.6e-5)
    np.testing.assert_allclose(hp.k.numpy(), 10.0)
    ej.mat.elems_th[0].alpha = d["thermo"][0]
    ej.mat.set_thermal_conductivity(d["thermal"]["k"])
    hj.initialize()
    ej._jit_tm_msteps = None          # the material changed under the jit
    _steps(ej, hj, 3, 2)
    _steps(ep, hp, 3, 2)
    _close_eqs(ep, ej, 1e-9, (hp, hj))
    back = interop.numpy_state(ep, hp)
    _close(back["heat"]["T"], hj.T, 1e-9, "heat T")


def _mohr_coulomb(pkg, n, dev):
    one = np.ones(n)
    return pkg.MohrCoulombViscoplastic(
        mu_1=1e-9 * one, N_1=1.0 * one, cohesion=0.5 * one,
        friction_angle=np.radians(30.0) * one,
        dilation_angle=np.radians(5.0) * one, sigma_t=1.0 * one, **dev)


def test_mohr_coulomb_thermoelastic_cube_matches_jax():
    runs = {}
    for pkg in (sc, st):
        eq, heat = cfg.tm_cube(pkg, "cpu", extra=_mohr_coulomb)
        rows = cfg.run_tm_steps(eq, heat)
        assert (rows[:, 1] <= 1e-6).all()
        runs[pkg.__name__] = (eq, heat, rows)
    ej, hj, rj = runs["safeincave_tpu"]
    ep, hp, rp = runs["safeincave_torch"]
    np.testing.assert_array_equal(rp[:, 0], rj[:, 0])
    _close_eqs(ep, ej, 1e-8, (hp, hj))
    Fvp = cfg.as_np(ej.mat.elems_ne[-1].state["Fvp"])
    assert (Fvp > 0).any(), "the cube never yields: the test shows nothing"
    _close(ep.mat.elems_ne[-1].state["Fvp"], Fvp, 1e-8, "Fvp")


def test_fp32_sweep_carries_the_thermal_strain():
    """With the f32 sweep forced on (CPU) and its hand-over threshold opened
    to one iteration, the coupled chunk is handed the step's float64 thermal
    strain, accepts a sweep on the steps after the top's 32 K jump, and
    lands on the float64 path's fields.  An accepted sweep's iterate is one
    float64 fixed-point iteration of the same step to the sweep's solve
    tolerance; the same iteration without the thermal strain is far off."""
    out, seen, sweeps = {}, [], []
    for fp32 in (True, False):
        eq, heat = cfg.tm_cube(st, "cpu")
        eq.set_solver(st.SolverSettings(method="bicgstab", rtol=1e-12,
                                        max_it=500, fp32_phase=fp32,
                                        fp32_switch=0.99))
        cfg.tm_start(eq, heat)
        real, fixed_point = eq._fp32_sweep, eq._fixed_point

        def spy(*args, **kw):
            seen.append(args[7])
            res = real(*args, **kw)
            if res[4]:                              # accepted
                dt = args[8]
                one = {k: fixed_point(*args[:7], dt, 0.0, 1, fp32_on=False,
                                      eps_th=e)[2]
                       for k, e in (("with", args[7]), ("without", None))}
                sweeps.append((res[2], one["with"], one["without"]))
            return res
        eq._fp32_sweep = spy
        rows = eq.solve_tm_time_steps(heat, [(k + 1) * HOUR
                                             for k in range(3)], [HOUR] * 3,
                                      tol=1e-8, maxiter=40)
        assert (rows[:, 5] == 1).all()
        out[fp32] = eq
    eq32, eq64 = out[True], out[False]
    assert eq32.fp32_accepted == len(sweeps) >= 2 and eq64.fp32_accepted == 0
    assert len(seen) == 3           # the f64-only run never enters the sweep
    assert all(e.dtype == torch.float64 and float(e.abs().max()) > 0
               for e in seen)
    for got, want, without in sweeps:
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) < 2e-2 * scale
        assert float((without - want).abs().max()) > 0.2 * scale
    for k in FIELDS:
        _close(getattr(eq32, k), getattr(eq64, k), 2e-7, k)
