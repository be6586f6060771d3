"""PyTorch port vs JAX package: the simulation driver path.

``Simulator_M`` of both packages on tests/test_output_config.py's 2x2x2
creep box (``torch_port_configs.small_box``), with ``SaveFields`` of u,
p_elems, q_elems and sig, in the per-step flow (``save_every=1``) and in
fused chunks (``save_every=3``).  Both outputs are read back with the JAX
package's ``postproc.read_timeseries``: equal times, fields within 1e-9 of
max|ref| at every save.  StepMetrics rows: equal step, t, dt, fixed-point
iterations and converged flags (Krylov counts may differ on the CPU, see
ROADMAP.md queue 3).  Screen rows: equal step, dt, t and iterations.

The dt-retry mirrors tests/test_dt_retry.py on the port: a poisoned first
attempt is rolled back bit for bit and recovers at dt/2 to the state of a
run that failed without poisoning; exhausted retries restore the backup and
write ``nan_diagnostic.npz`` with the JAX package's keys.
"""
import json
import os

import numpy as np
import pytest
import torch

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_tpu import postproc

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FIELDS = ("u", "p_elems", "q_elems", "sig")
N_STEPS = 4


def _run(pkg, folder, save_every):
    eq = cfg.small_box(pkg, "cpu")
    out = pkg.SaveFields(eq, save_every=save_every)
    out.set_output_folder(folder)
    for f in FIELDS:
        out.add_output_field(f, f)
    tc = pkg.TimeController(dt=1.0, initial_time=0.0,
                            final_time=float(N_STEPS), time_unit="hour")
    metrics = pkg.StepMetrics(os.path.join(folder, "metrics.jsonl"))
    sim = pkg.Simulator_M(eq, tc, [out], metrics=metrics)
    sim.run()
    return sim


def _rows(lines):
    """(step, dt, t, iterations) of each step row of a screen transcript."""
    rows = []
    for line in lines:
        cells = [c.strip() for c in line.split("|")]
        if len(cells) == 5 and cells[0].isdigit():
            rows.append(tuple(cells[:4]))
    return rows


@pytest.fixture(scope="module", params=[1, 3], ids=["per_step", "fused"])
def both(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"sim{request.param}")
    return {pkg.__name__: (_run(pkg, str(root / pkg.__name__),
                                request.param), str(root / pkg.__name__))
            for pkg in (sc, st)}


def test_outputs_match_jax(both):
    (_, jax_dir), (sim, port_dir) = both["safeincave_tpu"], \
        both["safeincave_torch"]
    for f in FIELDS:
        t_ref, ref, pts_ref, topo_ref = postproc.read_timeseries(jax_dir, f)
        t, got, pts, topo = postproc.read_timeseries(port_dir, f)
        np.testing.assert_array_equal(t, t_ref)
        np.testing.assert_array_equal(pts, pts_ref)
        np.testing.assert_array_equal(topo, topo_ref)
        assert got.shape == ref.shape
        for k in range(ref.shape[0]):
            scale = np.abs(ref[k]).max()
            assert np.abs(got[k] - ref[k]).max() <= 1e-9 * scale, (f, k)
        with open(os.path.join(port_dir, f, f"{f}.xdmf")) as a, \
                open(os.path.join(jax_dir, f, f"{f}.xdmf")) as b:
            assert a.read() == b.read(), f
    assert os.path.isfile(os.path.join(port_dir, "log.txt"))


def test_metrics_match_jax(both):
    (_, jax_dir), (_, port_dir) = both["safeincave_tpu"], \
        both["safeincave_torch"]

    def load(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]
    ref, got = load(jax_dir), load(port_dir)
    assert len(got) == len(ref) == N_STEPS
    for r, g in zip(ref, got):
        for key in ("step", "t", "dt", "fp_iters", "converged", "dt_cuts"):
            assert g[key] == r[key], key
        assert g.get("fused", False) == r.get("fused", False)
        assert g["error"] <= 1e-8


def test_screen_rows_match_jax(both):
    jax_sim, port_sim = both["safeincave_tpu"][0], \
        both["safeincave_torch"][0]
    ref, got = _rows(jax_sim.screen.lines), _rows(port_sim.screen.lines)
    assert len(got) == N_STEPS
    assert got == ref
    assert any("device: cpu" in line for line in port_sim.screen.lines)


def test_chunk_plan_follows_save_points(both):
    """save_every=3 over 4 steps writes at calls 0 and 3, as the per-step
    flow would; every step's metrics row is flagged as fused."""
    sim, folder = both["safeincave_torch"]
    t, _, _, _ = postproc.read_timeseries(folder, "u")
    every = sim.outputs[0].save_every
    np.testing.assert_array_equal(
        t, cfg.HOUR * np.arange(0, N_STEPS + 1, every))
    assert all(r.get("fused", False) == (every > 1)
               for r in sim.metrics.records)


# --------------------------------------------------------------------------- #
# dt-retry
# --------------------------------------------------------------------------- #
def _snapshot(eq):
    return ([eq.u.clone(), eq.sig_v.clone(), eq.eps_tot_v.clone()],
            [{k: v.clone() for k, v in e.state.items()}
             for e in eq.mat.elems_ne])


def _assert_bitwise(eq, snap):
    fields, states = snap
    for got, want in zip([eq.u, eq.sig_v, eq.eps_tot_v], fields):
        assert torch.equal(got, want)
    for e, st_ in zip(eq.mat.elems_ne, states):
        assert e.state.keys() == st_.keys()
        for k, v in st_.items():
            assert torch.equal(e.state[k], v), k


def _failing(eq, n_failures, poison):
    """Wrap solve_time_step: the first n calls report NaN (poisoning the
    state first when ``poison``), later calls run normally.  Every call
    after the first checks that it starts from the first call's state."""
    real = eq.solve_time_step
    calls = {"n": 0, "dts": [], "entry": None}

    def wrapped(t, dt, tol=1e-8, maxiter=40):
        calls["n"] += 1
        calls["dts"].append(dt)
        if calls["entry"] is None:
            calls["entry"] = _snapshot(eq)
        else:
            _assert_bitwise(eq, calls["entry"])
        if calls["n"] <= n_failures:
            eq._last_sv_k = eq.sig_v     # as a real failed attempt leaves it
            if poison:
                nan = float("nan")
                eq.u = eq.u * nan
                eq.sig_v = eq.sig_v * nan
                eq.eps_tot_v = eq.eps_tot_v * nan
                eq._last_sv_k = eq.sig_v
                for e in eq.mat.elems_ne:
                    e.state = {k: v * nan for k, v in e.state.items()}
            return maxiter, float("nan")
        return real(t, dt, tol=tol, maxiter=maxiter)

    eq.solve_time_step = wrapped
    return calls


def _retry_run(cls, n_failures, poison):
    eq = cfg.small_box(st, "cpu", top=8e6)
    tc = st.TimeController(dt=1.0, initial_time=0.0, final_time=1.0,
                           time_unit="hour")
    metrics = st.StepMetrics()
    sim = cls(eq, tc, outputs=[], metrics=metrics)
    calls = _failing(eq, n_failures, poison)
    sim.run()
    return eq, sim, calls


def test_dt_retry_recovers_after_nan(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    eq, sim, calls = _retry_run(st.Simulator_M, 1, poison=True)
    clean, _, _ = _retry_run(st.Simulator_M, 1, poison=False)
    assert calls["dts"] == [3600.0, 1800.0]
    rec = sim.metrics.records[-1]
    assert rec["converged"] and rec["dt_cuts"] == 1 and rec["error"] <= 1e-8
    assert eq._fp32_disable is False
    _assert_bitwise(eq, _snapshot(clean))
    assert not os.path.exists("nan_diagnostic.npz")


def test_exhausted_retries_restore_and_dump(tmp_path, monkeypatch):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    monkeypatch.chdir(port_dir)
    eq, sim, calls = _retry_run(st.Simulator_M, 10, poison=True)
    rec = sim.metrics.records[-1]
    assert not rec["converged"]
    assert rec["dt_cuts"] == sim.max_dt_cuts + 1
    assert calls["n"] == sim.max_dt_cuts + 1
    _assert_bitwise(eq, calls["entry"])
    port_keys = set(np.load("nan_diagnostic.npz").files)

    # the JAX package's dump of the same failure
    monkeypatch.chdir(jax_dir)
    jeq = cfg.small_box(sc, top=8e6)

    def fail(t, dt, tol=1e-8, maxiter=40):
        jeq._last_sv_k = jeq.sig_v
        return maxiter, float("nan")
    jeq.solve_time_step = fail
    sc.Simulator_M(jeq, sc.TimeController(dt=1.0, initial_time=0.0,
                                          final_time=1.0, time_unit="hour"),
                   outputs=[]).run()
    assert port_keys == set(np.load("nan_diagnostic.npz").files)


def test_mout_has_no_retry(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    eq, sim, calls = _retry_run(st.Simulator_Mout, 1, poison=True)
    assert calls["dts"] == [3600.0]
    rec = sim.metrics.records[-1]
    assert not rec["converged"] and rec["dt_cuts"] == 1
    _assert_bitwise(eq, calls["entry"])


def test_fused_chunk_failure_rewinds_to_per_step_retry():
    """A step that fails inside a fused chunk hands back its entry state:
    the driver re-runs exactly that step in the per-step flow (without the
    f32 sweep), then fuses again, and ends where an undisturbed run ends."""
    def run(fail_call):
        eq = cfg.small_box(st, "cpu", top=8e6)
        real, calls = eq._fixed_point, {"n": 0}

        def fixed_point(*args, **kw):
            calls["n"] += 1
            out = real(*args, **kw)
            if calls["n"] == fail_call:
                out = out[:6] + (float("nan"),) + out[7:]
            return out
        eq._fixed_point = fixed_point
        metrics = st.StepMetrics()
        st.Simulator_M(eq, st.TimeController(
            dt=1.0, initial_time=0.0, final_time=float(N_STEPS),
            time_unit="hour"), [], metrics=metrics).run()
        return eq, metrics.records

    eq, recs = run(fail_call=3)
    clean, clean_recs = run(fail_call=None)
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert [r.get("fused", False) for r in recs] == [True, True, False, True]
    assert all(r["converged"] and r["dt_cuts"] == 0 for r in recs)
    assert eq._fp32_disable is False
    assert [r["t"] for r in recs] == [r["t"] for r in clean_recs]
    for name in ("u", "sig_v", "eps_tot_v"):
        torch.testing.assert_close(getattr(eq, name), getattr(clean, name),
                                   rtol=1e-12, atol=0)


# --------------------------------------------------------------------------- #
# the 4_cavern workflow against its golden (slow: ~60 steps on cavern600)
# --------------------------------------------------------------------------- #
@pytest.mark.slow
def test_sim_cavern600_golden_cpu(tmp_path):
    golden = np.load(os.path.join(HERE, "golden",
                                  "torch_port_sim_cavern600.npz"))
    eq = cfg.cavern_example(st, "cpu")
    for prefix, stage in (("eq", "equilibrium"), ("op", "operation")):
        m = st.StepMetrics()
        cfg.run_cavern_stage(st, eq, stage, [], metrics=m)
        rec = cfg.stage_record(eq, m)
        np.testing.assert_array_equal(rec["rows"][:, 2],
                                      golden[f"{prefix}_rows"][:, 2])
        fields = [f for f in cfg.STAGE_FIELDS if f"{prefix}_{f}" in golden]
        assert "u" in fields and "p_elems" in fields
        for f in fields:
            ref = golden[f"{prefix}_{f}"]
            assert np.abs(rec[f] - ref).max() <= 1e-8 * np.abs(ref).max(), f


# --------------------------------------------------------------------------- #
# LinearMomentumBase orchestration the drivers and user scripts call
# --------------------------------------------------------------------------- #
def test_base_orchestration_matches_jax():
    """compute_eps_ne_k, increment_internal_variables and the p/q fields
    of the bench material (Desai included) on a 2x2x2 box, after the elastic
    response and rates at a seeded deviatoric stress, 1e-12 of max|ref|."""
    eqs = {}
    for pkg in (sc, st):
        eq = cfg.wire_bench(pkg, pkg.GridBox(nx=2, ny=2, nz=2), device="cpu")
        cfg.elastic_init(eq)
        rng = np.random.default_rng(3)
        sig = cfg.as_np(eq.sig_v) + 4e6 * rng.normal(size=(eq.n_elems, 6))
        eq.compute_eps_ne_rate(sig, 0.0)
        eq.eps_k_sum = eq.compute_eps_ne_k(cfg.HOUR)
        eq.increment_internal_variables(1.01 * sig, sig, cfg.HOUR)
        eq.sig_v = torch.as_tensor(sig) if pkg is st else sig
        for name in ("p_elems", "q_elems", "p_nodes", "q_nodes"):
            getattr(eq, f"compute_{name}")()
        eqs[pkg.__name__] = eq
    ref, got = eqs["safeincave_tpu"], eqs["safeincave_torch"]

    def close(a, b, what):
        a, b = cfg.as_np(a), cfg.as_np(b)
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1e-300), \
            what
    close(got.eps_k_sum, ref.eps_k_sum, "eps_k")
    for name in ("p_elems", "q_elems", "p_nodes", "q_nodes"):
        close(getattr(got, name), getattr(ref, name), name)
    # the keys these calls set (the rest hold the hydrostatic elastic
    # state's rounding noise, ~1e-48)
    for e_got, e_ref in zip(got.mat.elems_ne, ref.mat.elems_ne):
        for k in ("rate", "eps_k", "alpha", "qsi"):
            if k in e_ref.state:
                close(e_got.state[k], e_ref.state[k], f"{e_ref.name} {k}")
    assert np.abs(cfg.as_np(got.eps_k_sum)).max() > 0
