"""Write the port's goldens from the JAX package on CPU.

- ``tests/golden/torch_port_cavern600.npz``: the cavern benchmark
  configuration on grids/cavern_proxy_600 (band reordered), with the
  2level preconditioner and the fp32 phase off;
- ``tests/golden/torch_port_box17.npz``: bench.py's box configuration
  (``GridBox(600, 600, 800, nx=17)``, natural order) with the same material
  and loads, ``enable_dia_matvec()``, the 2level preconditioner and the
  fp32 phase forced on (on the CPU, "auto" would turn it off).

Each holds ``u`` after the elastic phase, then ``u``, ``sig_v`` and the
per-step stats rows after 3 steps of ``solve_time_steps`` at dt = 3600 s,
tol 1e-8.

- ``tests/golden/torch_port_sim_cavern600.npz``: the 4_cavern workflow
  (``torch_port_configs.cavern_example``, 2level, fp32 phase off, cumsum
  operator) through ``Simulator_M``: equilibrium 24 h at 2 h with
  ``SaveFields`` of u and p_elems every step, then operation 48 h at 1 h
  with ``SaveFields(save_every=6)`` of u, p_elems and q_elems and a
  checkpoint every 12 steps;
- ``tests/golden/torch_port_json_box17.npz``: ``Simulator_GUI`` on
  ``torch_port_configs.box_case`` over ``box_mesh(600, 600, 800, nx=17)``
  written with ``write_msh``.

- ``tests/golden/torch_port_tm_cavern600.npz``: bench.py's
  thermo-mechanical configuration (``torch_port_configs.wire_tm``, Robin
  wall on "Cavern") on the band-ordered cavern_proxy_600 mesh through
  ``Simulator_TM``, 24 steps at 1 h with ``SaveFields(save_every=6)`` of u
  and of T: final ``u``, ``sig_v``, ``T`` and the step table ``rows``
  (fixed-point iterations, error);
- ``tests/golden/torch_port_t_cavern600.npz``: 6 steps of ``Simulator_T`` on
  the same heat equation: final ``T``;
- ``tests/golden/torch_port_tm_box17.npz``: the same configuration on the
  natural-order box17 (Robin wall on BOTTOM) with ``enable_dia_matvec()``
  and the fp32 phase forced on, 8 steps of bare ``solve_tm_time_steps``
  after ``tm_init``: ``u``, ``sig_v``, ``T`` and the (8, 6) ``rows``.

- ``tests/golden/torch_port_lag_cavern600.npz`` and
  ``torch_port_adaptive_cavern600.npz``: the cavern600 configuration with
  ``lag_tangent=True`` / ``adaptive_rtol=True``, 13 steps (a chunk of 3 and
  one of 10) as chip_smoke.py's lag phase runs each way: ``rows``, ``u``,
  ``sig_v``;
- ``tests/golden/torch_port_yearly_1200.npz``: the yearly production run of
  examples/mechanics/nobian_yearly ``--full``
  (``torch_port_configs.yearly_build``: the band-ordered 38k-tet
  cavern_interlayer_1200 mesh, 2level, fp32 phase off) through
  ``Simulator_M``: equilibrium 30 days at 5 days, then the first 4 days of
  the CSV year at 6 h with saves every 8 steps and a checkpoint at step
  16; per stage (``eq_`` / ``op_``) the step table, ``u``, ``sig_v`` (and
  ``q_elems`` in operation);
- ``tests/golden/torch_port_halo_cavern600.npz``: the cavern600
  configuration above converted by ``shard_equation(eq,
  make_device_mesh(8), mode="halo")`` over 8 virtual CPU devices (the
  halo two-level preconditioner, ``coarse_agg=8``): ``u_elastic``, and
  ``u``, ``sig_v`` (the first ``n_elems_orig`` rows: the element padding
  sliced off) and ``rows`` after 3 steps, as ``torch_port_cavern600.npz``
  holds them;
- ``tests/golden/torch_port_point.npz``: calibrate_creep.py's fit (300
  Adam steps: fitted ``A``, ``n`` and the loss history) and one
  ``TriaxialSimulator.run_compression`` of calibrate_triaxial.py's twin at
  its true parameters (``S_diff``, ``sig_zz``, ``eps_vol``, ``eps_ne``).

- ``tests/golden/torch_port_examples_<name>.npz``: each example of
  ``torch_port_configs.EXAMPLE_RUNS`` run through the JAX script's
  ``main`` on the CPU, at the arguments chip_smoke.py's phase 17 gives its
  twin on the card (``card.`` keys) and, where they differ, at the CPU
  tests' shortened arguments (``cpu.`` keys): per saved field the last
  save and the save times, per transcript the iteration column
  (``torch_port_configs.example_record``).  thermal/2_cavern runs on
  cavern_proxy_600 with its faces renamed as the reference mesh names
  them (``reference_named_proxy``).  The calibrations (``creep``,
  ``labdata``, ``triaxial_fit``, ``multimodel``) hold the JAX package's
  fitted parameters (``sc.calibrate`` on the JAX script's forward model)
  on the twin's observed record, which is stored beside them, at the
  twin's Adam steps on the card.

- ``tests/golden/torch_port_oracle_cube.npz``: tests/test_reference_oracle.py's
  set-up (``torch_port_configs.oracle_run``): u, the total strain and
  Desai's alpha after the elastic response and after one step, and the
  step's iterations and error, in the JAX package's node order, so that
  the card can be held to the JAX package entry for entry beside the
  original stack's sorted oracle.

The two mechanics simulator goldens hold, per stage (``eq_`` and ``op_``
prefixes), the step table (fixed-point iterations, error, converged) and
the final fields the stage saves (u and p_elems; q_elems too in operation).
The machine that runs ``chip_smoke.py`` on the GPU has no JAX, so it reads
these files.

Run from the repository root (one or more names, default all):

    JAX_PLATFORMS=cpu python tests/generate_torch_port_golden.py [name ...]
"""
import os
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
# 8 virtual CPU devices for the halo case, set before JAX is imported (as
# tests/conftest.py sets them)
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS",
                                                                ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import safeincave_tpu as sc  # noqa: E402
import safeincave_tpu.config  # noqa: E402,F401
import torch_port_configs as cfg  # noqa: E402

N_STEPS = 3
LAG_CHUNKS = (3, 10)
TRIAX_TIMES = np.linspace(0.0, 2000.0, 81)


def _cavern600():
    return cfg.wire_bench(sc, cfg.cavern600_grid(sc))


def _box17():
    eq = cfg.wire_bench(sc, cfg.box17_grid(sc), fp32_phase=True)
    eq.enable_dia_matvec()
    return eq


def _halo_cavern600():
    from safeincave_tpu.parallel import make_device_mesh, shard_equation
    eq = _cavern600()
    shard_equation(eq, make_device_mesh(8), mode="halo")
    return eq


def write_steps(make):
    eq = make()
    cfg.elastic_init(eq)
    u_elastic = np.asarray(eq.u)
    elastic_krylov = eq.solver_stats[0]
    dt = cfg.HOUR
    rows = eq.solve_time_steps([(k + 1) * dt for k in range(N_STEPS)],
                               [dt] * N_STEPS, tol=1e-8, maxiter=40)
    return dict(u_elastic=u_elastic, elastic_krylov=elastic_krylov,
                u=np.asarray(eq.u),
                sig_v=np.asarray(eq.sig_v)[:getattr(eq, "n_elems_orig",
                                                    eq.n_elems)],
                rows=np.asarray(rows))


# what each stage's record keeps: the fields its outputs save
STAGE_KEYS = {"eq": ("rows", "u", "p_elems"),
              "op": ("rows", "u", "p_elems", "q_elems")}


def _stages(records):
    return {f"{prefix}_{k}": rec[k]
            for prefix, rec in zip(STAGE_KEYS, records)
            for k in STAGE_KEYS[prefix]}


def sim_cavern600(tmp):
    """The 4_cavern workflow, as chip_smoke.py's sim phase runs it."""
    eq = cfg.cavern_example(sc)
    records = []
    for stage, fields, every, extra in (
            ("equilibrium", ("u", "p_elems"), 1, {}),
            ("operation", ("u", "p_elems", "q_elems"), 6,
             dict(checkpoint_every=12,
                  checkpoint_path=os.path.join(tmp, "ck.npz")))):
        out = sc.SaveFields(eq, save_every=every)
        out.set_output_folder(os.path.join(tmp, stage))
        for f in fields:
            out.add_output_field(f, f)
        m = sc.StepMetrics()
        cfg.run_cavern_stage(sc, eq, stage, [out], metrics=m, **extra)
        records.append(cfg.stage_record(eq, m))
    return _stages(records)


def json_box17(tmp):
    """The JSON driver on box17, as chip_smoke.py's json phase runs it."""
    grid_dir = os.path.join(tmp, "grid")
    os.makedirs(grid_dir)
    sc.mesh.write_msh(os.path.join(grid_dir, "geom.msh"),
                      *sc.mesh.box_mesh(600.0, 600.0, 800.0, 17, 17, 17))
    records = []
    real = sc.config.Simulator_M
    sc.config.Simulator_M = cfg.recording_simulator(sc, records)
    try:
        sc.Simulator_GUI(cfg.box_case(grid_dir, os.path.join(tmp, "out")))\
            .run()
    finally:
        sc.config.Simulator_M = real
    return _stages(records)


def _save_fields(eq, folder, field):
    out = sc.SaveFields(eq, save_every=6)
    out.set_output_folder(folder)
    out.add_output_field(field, field)
    return out


def tm_cavern600(tmp):
    """Simulator_TM on cavern600, as chip_smoke.py's tm phase runs it."""
    eq, heat = cfg.wire_tm(sc, cfg.cavern600_grid(sc), "Cavern")
    outs = [_save_fields(eq, os.path.join(tmp, "u"), "u"),
            _save_fields(heat, os.path.join(tmp, "T"), "T")]
    _, rows = cfg.run_tm_sim(sc, eq, heat, outs)
    return dict(u=np.asarray(eq.u), sig_v=np.asarray(eq.sig_v),
                T=np.asarray(heat.T), rows=rows)


def t_cavern600(tmp):
    """Simulator_T on the same heat equation, 6 steps."""
    _, heat = cfg.wire_tm(sc, cfg.cavern600_grid(sc), "Cavern")
    tc = sc.TimeController(dt=1.0, initial_time=0.0, final_time=6.0,
                           time_unit="hour")
    sc.Simulator_T(heat, tc, [_save_fields(heat, os.path.join(tmp, "T"),
                                           "T")]).run()
    return dict(T=np.asarray(heat.T))


TM_BOX_STEPS = 8


def tm_box17(tmp):
    """Bare solve_tm_time_steps on box17, as chip_smoke.py's tm_box phase
    runs it."""
    eq, heat = cfg.wire_tm(sc, cfg.box17_grid(sc), "BOTTOM", fp32_phase=True)
    eq.enable_dia_matvec()
    cfg.tm_init(eq, heat)
    dt = cfg.HOUR
    rows = eq.solve_tm_time_steps(
        heat, [(k + 1) * dt for k in range(TM_BOX_STEPS)],
        [dt] * TM_BOX_STEPS, tol=1e-6, maxiter=20)
    return dict(u=np.asarray(eq.u), sig_v=np.asarray(eq.sig_v),
                T=np.asarray(heat.T), rows=np.asarray(rows))


def flagged_cavern600(flags):
    """cavern600 with a solver option on, over LAG_CHUNKS."""
    eq = cfg.wire_flagged(sc, cfg.cavern600_grid(sc), flags)
    cfg.elastic_init(eq)
    dt, t, rows = cfg.HOUR, cfg.HOUR, []
    for n in LAG_CHUNKS:
        rows.append(np.asarray(eq.solve_time_steps(
            [t + k * dt for k in range(n)], [dt] * n, tol=1e-8, maxiter=40)))
        t += n * dt
    return dict(rows=np.concatenate(rows), u=np.asarray(eq.u),
                sig_v=np.asarray(eq.sig_v))


def yearly_1200(tmp):
    """The yearly production run, as chip_smoke.py's yearly phase runs
    it."""
    grid, eq = cfg.yearly_build(sc)
    data = {}
    for prefix, stage, every, extra in (
            ("eq", "equilibrium", 1, {}),
            ("op", "operation", cfg.YEARLY_SAVE_EVERY,
             dict(checkpoint_every=cfg.YEARLY_CHECKPOINT_EVERY,
                  checkpoint_path=os.path.join(tmp, "ck.npz")))):
        out = sc.SaveFields(eq, save_every=every)
        out.set_output_folder(os.path.join(tmp, stage))
        for f in cfg.YEARLY_FIELDS[stage]:
            out.add_output_field(f, f)
        m = sc.StepMetrics()
        cfg.run_yearly_stage(sc, eq, grid, stage, [out], metrics=m, **extra)
        data.update({f"{prefix}_{k}": v for k, v
                     in cfg.yearly_record(eq, m, stage).items()})
    return data


def point(tmp):
    """The calibration fit and the triaxial twin, as chip_smoke.py's point
    phase runs them."""
    import jax.numpy as jnp
    observed = cfg.creep_observed()
    fitted, history = sc.calibrate(
        cfg.creep_model(jnp.exp, jnp.asarray), observed=observed,
        loss_scale=np.abs(observed).max(), **cfg.CREEP_FIT)
    res, _ = cfg.triaxial_twin(sc, cfg.TRIAX_TRUE["cohesion"],
                               cfg.TRIAX_TRUE["friction"], TRIAX_TIMES,
                               jnp.ones)
    return dict(fit_A=np.asarray(fitted["A"]), fit_n=np.asarray(fitted["n"]),
                history=np.asarray(history), triax_times=TRIAX_TIMES,
                **{k: np.asarray(res[k])
                   for k in ("S_diff", "sig_zz", "eps_vol", "eps_ne")})


def _example(name):
    import safeincave_tpu.postproc as pp

    def make(tmp):
        script, cpu_kw, card_kw = cfg.EXAMPLE_RUNS[name]
        data = {}
        for sched, kw in [("card", card_kw)] + (
                [("cpu", cpu_kw)] if cpu_kw != card_kw else []):
            run = os.path.join(tmp, sched)
            kw = cfg.example_kwargs(sc, name, kw, os.path.join(tmp, "grid"))
            cfg.run_example("safeincave_tpu", script, run, kw)
            rec = cfg.example_record(os.path.join(run, "output"),
                                     pp.read_timeseries)
            data.update({f"{sched}.{k}": v for k, v in rec.items()})
        return data
    return make


def triaxial_sweep(tmp):
    """1_triaxial at its defaults with the f32 sweep forced on (``card.``
    keys, and ``halvings.card``: the dt halvings of the run), then the
    same with the jacobi preconditioner, which changes nothing but the
    f32 Krylov iterates' round-off: ``spread.<field>`` is that run's
    distance from the first (max|diff| / max|ref|), ``halvings.jacobi``
    its halvings."""
    import contextlib
    import io
    import safeincave_tpu.postproc as pp
    script, _, kw = cfg.SWEEP_RUNS["triaxial_sweep"]
    data = {}
    for way, extra in (("card", {}), ("jacobi", {"precond": "jacobi"})):
        run, err = os.path.join(tmp, way), io.StringIO()
        with cfg.fp32_forced(sc, True, **extra), \
                contextlib.redirect_stderr(err):
            cfg.run_example("safeincave_tpu", script, run, kw)
        rec = cfg.example_record(os.path.join(run, "output"),
                                 pp.read_timeseries)
        data[f"halvings.{way}"] = np.asarray(
            err.getvalue().count("halving dt"))
        if way == "card":
            data.update({f"card.{k}": v for k, v in rec.items()})
            continue
        data.update({f"spread.{k}": np.asarray(
            np.abs(v - data[f"card.{k}"]).max()
            / np.abs(data[f"card.{k}"]).max())
            for k, v in rec.items()
            if not (k.endswith(".times") or k.endswith("log"))})
    return data


def _fit(model, params0, observed, **kw):
    fitted, _ = sc.calibrate(model, params0=params0, observed=observed,
                             loss_scale=float(np.abs(observed).max()), **kw)
    return {f"fit.{k}": np.asarray(v) for k, v in fitted.items()}


def _calibration(name):
    def make(tmp):
        script = cfg.CALIBRATIONS[name]
        jx = cfg.load_example("safeincave_tpu", script)
        twin = cfg.load_example("safeincave_torch", script)
        if name == "creep":
            obs = twin["observed_record"]("cpu")
            out = _fit(jx["axial_creep_strain"], {"A": 5e-20, "n": 2.5},
                       obs, lr=0.05, steps=300)
        elif name == "labdata":
            rec = jx["load_ifg_creep_csv"](os.path.join(
                cfg.EXAMPLE_TREES["safeincave_tpu"], "mechanics",
                "MaterialCalibration", "data", "ZW_TCC4.csv"))
            obs = rec["eps_axial"] - rec["eps_axial"][0]
            out = _fit(jx["make_forward"](rec),
                       {"A": 1e-36, "n": 4.0, "eta1": 1e14, "E1": 5e9},
                       obs, lr=0.08, steps=400)
        elif name == "triaxial_fit":
            obs = twin["observed_curves"]("cpu")
            out = _fit(lambda p: jx["run_twin"](p["cohesion"],
                                                p["friction"]),
                       {"cohesion": 1.5, "friction": 22.0 * jx["DEG"]},
                       obs, lr=0.08, steps=cfg.TRIAXIAL_FIT_STEPS)
        else:
            t_s, s1, s3, _ = jx["staged_schedule"]()
            obs_sic, obs_md = twin["observed_records"](t_s, s1, s3, "cpu")
            out = {f"sic.{k}": v for k, v in _fit(
                lambda p: jx["sic_axial_strain"](p, t_s, s1, s3),
                {"A": 5e-20, "n": 2.5, "eta": 3e14, "E1": 5e9}, obs_sic,
                lr=0.05, steps=cfg.MULTIMODEL_STEPS).items()}
            out.update({f"md.{k}": v for k, v in _fit(
                lambda p: jx["md_axial_strain"](p, t_s, s1, s3),
                {"A": 5e-20, "n": 2.5, "K0": 3e6, "delta": 0.3}, obs_md,
                lr=0.05, steps=cfg.MULTIMODEL_STEPS).items()})
            obs = np.stack([obs_sic, obs_md])
        return {**out, "observed": np.asarray(obs)}
    return make


def _tmcyc_run(path, precond):
    """One TM-cyclic path as bench_tm_cyclic drives it: the elastic
    response, the first step alone, then TM_CYCLIC_STEPS more."""
    eq, heat = cfg.tm_cyclic_path(sc, path, precond=precond,
                                  auto_backend=False)
    cfg.tm_cyclic_init(eq, heat)
    out = {"u_elastic": np.asarray(eq.u)}
    rows1 = cfg.tm_cyclic_run(eq, heat, 1)
    out.update({f"{k}_1": v for k, v in cfg.tm_cyclic_fields(eq,
                                                             heat).items()})
    rows = cfg.tm_cyclic_run(eq, heat, cfg.TM_CYCLIC_STEPS,
                             t_first=2 * cfg.HOUR)
    out["rows"] = np.concatenate([rows1, rows])
    out.update(cfg.tm_cyclic_fields(eq, heat, pq=True))
    return out


def _dense_ready():
    """safeincave_tpu/fem/momentum.py's ``_dense_inverse_cached`` reads
    ``os.environ`` without importing ``os`` (a NameError on every
    ``precond="dense"`` build); the module gets the name here, and the
    package's files stay as they are."""
    import safeincave_tpu.fem.momentum as jm
    if not hasattr(jm, "os"):
        jm.os = os


def _tm_cyclic(path):
    """bench.py's TM-cyclic configuration ``path`` on the 2level
    preconditioner and the cumsum operator; then the same run on the dense
    preconditioner, whose distance from the first (``dense.*``: per field,
    max|dense - 2level| / max|2level|) is the spread that two
    preconditioners give under the fixed point's tolerance."""
    def make(tmp):
        ref = _tmcyc_run(path, "2level")
        _dense_ready()
        dense = _tmcyc_run(path, "dense")
        spread = {f"dense.{k}": np.asarray(
            np.abs(dense[k] - v).max() / np.abs(v).max())
            for k, v in ref.items() if k != "rows"}
        return {**ref, **spread, "dense.rows": dense["rows"]}
    return make


CASES = {"cavern600": lambda tmp: write_steps(_cavern600),
         "box17": lambda tmp: write_steps(_box17),
         "sim_cavern600": sim_cavern600, "json_box17": json_box17,
         "tm_cavern600": tm_cavern600, "t_cavern600": t_cavern600,
         "tm_box17": tm_box17,
         "lag_cavern600": lambda tmp: flagged_cavern600(
             {"lag_tangent": True}),
         "adaptive_cavern600": lambda tmp: flagged_cavern600(
             {"adaptive_rtol": True}),
         "yearly_1200": yearly_1200, "point": point,
         "halo_cavern600": lambda tmp: write_steps(_halo_cavern600),
         **{path: _tm_cyclic(path) for path in cfg.TM_CYCLIC},
         **{f"examples_{n}": _example(n) for n in cfg.EXAMPLE_RUNS},
         "examples_triaxial_sweep": triaxial_sweep,
         "oracle_cube": lambda tmp: cfg.oracle_run(sc),
         **{f"examples_{n}": _calibration(n) for n in cfg.CALIBRATIONS}}


def write(name):
    out = os.path.join(HERE, "golden", f"torch_port_{name}.npz")
    with tempfile.TemporaryDirectory() as tmp:
        data = CASES[name](tmp)
    np.savez_compressed(out, **data)
    print(f"wrote {out}: " + ", ".join(
        f"{k} {np.shape(v)}" for k, v in data.items()))


if __name__ == "__main__":
    for name in sys.argv[1:] or list(CASES):
        write(name)
