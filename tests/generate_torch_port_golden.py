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

These two hold, per stage (``eq_`` and ``op_`` prefixes), the step table
(fixed-point iterations, error, converged) and the final fields the stage
saves (u and p_elems; q_elems too in operation).  The machine that runs ``chip_smoke.py`` on the GPU has no JAX, so
it reads these files.

Run from the repository root (one or more names, default all):

    JAX_PLATFORMS=cpu python tests/generate_torch_port_golden.py [name ...]
"""
import os
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import safeincave_tpu as sc  # noqa: E402
import safeincave_tpu.config  # noqa: E402,F401
import torch_port_configs as cfg  # noqa: E402

N_STEPS = 3


def _cavern600():
    return cfg.wire_bench(sc, cfg.cavern600_grid(sc))


def _box17():
    eq = cfg.wire_bench(sc, cfg.box17_grid(sc), fp32_phase=True)
    eq.enable_dia_matvec()
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
                u=np.asarray(eq.u), sig_v=np.asarray(eq.sig_v),
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


CASES = {"cavern600": lambda tmp: write_steps(_cavern600),
         "box17": lambda tmp: write_steps(_box17),
         "sim_cavern600": sim_cavern600, "json_box17": json_box17}


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
