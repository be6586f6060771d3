"""The coupled interlayer cell of the benchmark, ``interlayer1200_tm.cyclic``,
on the CPU: its builder against bench_torch.py's ``build_tm_cyclic``
(interlayer branch), its rehearsal correct and yielding, the faults that
must make it not correct, and the run record that ``Simulator_TM`` leaves
with the Mohr-Coulomb yield counter, which adds no host read.

    python -m pytest -q tests/test_torch_interlayer_tm_cell.py

The four rehearsals (``benchmark/run.py --rehearse-cpu`` on the generated
two-interlayer cavern mesh with its overburden) run side by side in
children, one thread each.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_torch import tracing

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
CELL = "interlayer1200_tm.cyclic"
CONFIG = "interlayer1200_tm"


def _bench_modules():
    """(run.py, spec.py) of the benchmark, imported by path."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    import run
    import spec
    return run, spec


def test_builder_equals_bench_torch_interlayer_branch(tmp_path):
    """On the rehearsal mesh (two interlayer bands and an overburden), the
    cell's builder sets up what bench_torch.py's ``build_tm_cyclic`` does
    in its interlayer branch: material, both boundary handlers' tables,
    solver settings and temperatures, array for array."""
    run, spec = _bench_modules()
    folder = run.rehearsal_mesh(str(tmp_path))
    builder = spec.load_module(os.path.join(BENCH, "configs",
                                            f"{CONFIG}.py"), "il_tm_builder")
    got = cfg.setup_arrays(*builder.build(spec.load_json(
        "configs", f"{CONFIG}.json"), folder, "cpu"))
    ref = cfg.setup_arrays(*bench_torch.build_tm_cyclic(folder,
                                                        device="cpu"))
    common = cfg.assert_same_setup(got, ref)
    for table in ("heat_bc.", "bc._neumann_meta.", "mat.elems_th.",
                  "heat_T"):
        assert any(k.startswith(table) for k in common), table
    # the branch taken: Mohr-Coulomb on the interlayers alone, creep masked
    mu = next(v for k, v in got.items()
              if k.startswith("mat.elems_ne.") and k.endswith("params.mu_1"))
    assert 0 < np.count_nonzero(mu) < mu.size


# each fault is applied once the set-up is done, so that the timed path
# (the episodes) runs broken underneath an intact harness
FAULTS = {
    # no Mohr-Coulomb flow on the interlayers (the yield function stays)
    "mc_flow_zeroed": """
from safeincave_torch.materials.viscoplastic import MohrCoulombViscoplastic
real = MohrCoulombViscoplastic._rate_static
def rate(sv6, p):
    r, F = real(sv6, p)
    return r * 0.0, F
MohrCoulombViscoplastic._rate_static = staticmethod(rate)
""",
    # the thermal strain dropped from the right-hand side
    "no_thermal_strain": """
from safeincave_torch.fem.momentum import LinearMomentumBase
LinearMomentumBase.compute_eps_th = lambda self: None
""",
    # an answer altered where it is produced: the saved temperature
    "T_save_scaled": """
from safeincave_torch.output.xdmf import SaveFields
real = SaveFields._get_field
def get(self, name):
    a = real(self, name)
    return a * (1.0 + 1e-3) if name == "T" else a
SaveFields._get_field = get
""",
}


def _launch(fault, trace):
    """A child rehearsing the cell, with ``fault`` applied after set-up."""
    run_py = os.path.join(BENCH, "run.py")
    argv = [run_py, "--workload", CELL, "--seed", "2147483659",
            "--seconds", "0", "--trace", str(trace), "--rehearse-cpu"]
    prelude = "" if fault is None else (
        "import episodes\n"
        "_setup = episodes.Cell.setup\n"
        "def setup(self):\n"
        "    _setup(self)\n"
        f"    exec({FAULTS[fault]!r}, {{}})\n"
        "episodes.Cell.setup = setup\n")
    code = (f"import sys, runpy\n"
            f"sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n"
            f"{prelude}\n"
            f"sys.argv = {argv!r}\n"
            f"runpy.run_path({run_py!r}, run_name='__main__')\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ,
                                            "OMP_NUM_THREADS": "1"})


@pytest.fixture(scope="module")
def rehearsals():
    """{fault or "sound": (return code, result line or None, stderr)}:
    the sound run traced, each fault untraced, all at once."""
    procs = {"sound": _launch(None, 1)}
    procs.update({f: _launch(f, 0) for f in FAULTS})
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        lines = stdout.strip().splitlines()
        out[name] = (proc.returncode, json.loads(lines[-1])
                     if proc.returncode == 0 and lines else None, stderr)
    return out


def test_rehearsal_is_correct_and_the_interlayers_yield(rehearsals):
    """The sound rehearsal agrees with the plain reference, every step
    converged, the yield share is read and positive, and the program's own
    read count is the patched count."""
    rc, result, err = rehearsals["sound"]
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] == 24
    m = result["metrics"]
    assert 0 < m["mc_yield_pct"]["value"] <= 100
    assert m["mc_yield_pct"]["unit"] == "%"
    assert m["heat_cg_it_per_step"]["value"] > 0
    assert m["reads_per_step"]["value"] == m["host_reads_per_step"]["value"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_makes_the_cell_not_correct(rehearsals, fault):
    rc, result, err = rehearsals[fault]
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]


# -- the run record of Simulator_TM, on a 162-element cube ---------------- #
def _mc_cube():
    """tests/golden_configs.py's heated cube with a Mohr-Coulomb mechanism
    that can flow in its first half of elements (cohesion 0.5 MPa, so the
    5 MPa load yields them)."""
    def mc(pkg, n, dev):
        one = np.ones(n)
        mu = np.where(np.arange(n) < n // 2, 1e-9, 0.0)
        return pkg.MohrCoulombViscoplastic(
            mu_1=mu, N_1=one, cohesion=0.5 * one,
            friction_angle=np.radians(35.0) * one,
            dilation_angle=0.0 * one, sigma_t=1.0 * one, **dev)
    return cfg.tm_cube(st, "cpu", extra=mc)


@pytest.fixture(scope="module")
def tm_runs():
    """Two ``Simulator_TM`` runs of 4 h on one pair of equations, the first
    in one fused chunk, the second step by step: the records each left,
    and its reads counted by the benchmark's ``counting_reads`` and by the
    program."""
    _bench_modules()
    import episodes
    eq, heat = _mc_cube()
    out = []
    for fused in ("auto", 1):
        t0 = tracing.now()
        n0 = tracing.count_of("read")
        tc = st.TimeController(dt=1.0, initial_time=0.0, final_time=4.0,
                               time_unit="hour")
        sim = st.Simulator_TM(eq, heat, tc, [], fused_steps=fused)
        with episodes.counting_reads() as patched:
            sim.run()
        out.append(([r for r in tracing.runs if r["start_ns"] > t0],
                    patched[0],
                    tracing.count_of("read") - n0))
    return out, eq, eq.mat.elems_ne[-1]


def test_simulator_tm_leaves_one_run_record_per_run(tm_runs):
    runs, eq, mc = tm_runs
    assert mc.n_flowing == eq.n_elems // 2
    for records, _, _ in runs:
        assert len(records) == 1
        rec = records[0]
        assert rec["steps"] == 4 and rec["completed"] and not rec["cuda"]
        spans = rec["spans"]
        assert spans["run"]["count"] == 1
        for name in ("heat", "step", "commit", "fixed_point"):
            assert spans[name]["count"] == 4, name
        c = rec["counters"]
        assert c["fp_iterations"] >= 4 and c["krylov_iterations"] > 0
        assert c["mc_elem_steps"] == 4 * mc.n_flowing
        assert 0 < c["mc_yield_elems"] <= c["mc_elem_steps"]
    assert runs[0][0][0]["spans"]["chunk"]["count"] == 1
    assert "chunk" not in runs[1][0][0]["spans"]
    assert runs[1][0][0]["start_ns"] > runs[0][0][0]["end_ns"]
    assert eq.counters()["mc_elem_steps"] == 8 * mc.n_flowing


def test_the_yield_counter_adds_no_read(tm_runs):
    """Each run's program reads equal the reads ``counting_reads`` counts,
    and gathering the counters reads nothing through the tensor's read
    methods: the yield count stays on the device between the record's
    open and close."""
    runs, eq, _ = tm_runs
    import episodes
    for _, patched, program in runs:
        assert patched == program > 0
    with episodes.counting_reads() as patched:
        counters = eq.counters()
    assert patched[0] == 0
    assert isinstance(counters["mc_yield_elems"], int)
