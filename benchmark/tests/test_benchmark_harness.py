"""CPU tests of the benchmark: the manifest, every cell end to end on a
small generated mesh (``--rehearse-cpu``), the reference against the
program, the modules a run loads, a cell, a configuration, a traffic mix, a
metric and a kernel added as new files, the faults a cell can have, and the
control.

    python -m pytest -q benchmark/tests

The card's own runs go through ``python3 benchmark/run.py`` on the chip.
"""
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def manifest(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def rehearse(workload, seed=0, trace=0, root=ROOT, prelude=""):
    """One CPU rehearsal of ``workload`` in a child, after ``prelude`` (code
    run first, with the benchmark's modules importable); (return code, the
    result line as a dict or None, stderr)."""
    run_py = os.path.join(root, "benchmark", "run.py")
    argv = [run_py, "--workload", workload, "--seed", str(seed),
            "--seconds", "0", "--trace", str(trace), "--rehearse-cpu"]
    code = (f"import sys, runpy\n"
            f"sys.path[:0] = [{os.path.dirname(run_py)!r}, {root!r}]\n"
            f"{prelude}\n"
            f"sys.argv = {argv!r}\n"
            f"runpy.run_path({run_py!r}, run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900, cwd=root,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines \
        else None
    return proc.returncode, result, proc.stderr


def test_manifest_names_units_and_files():
    spec = manifest()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    cells = {w["name"]: w for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))
        assert set(m.get("workloads", [])) <= set(cells)
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
        assert "\n" not in m["layer"] and m["layer"]
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        for key in c["reduced"]:
            assert NAME.match(key)
        for folder in ("configs", "reference"):
            assert os.path.isfile(os.path.join(BENCH, folder,
                                               f"{c['name']}.py"))
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(BENCH, "limits",
                                           f"{w['name']}.json"))
        reported = [m["name"] for m in spec["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2


def coupled_cells(root=ROOT):
    """The workloads whose configuration has a heat equation."""
    spec = manifest(root)
    heat = set()
    for c in spec["configs"]:
        with open(os.path.join(root, c["file"])) as f:
            if "heat" in json.load(f):
                heat.add(c["name"])
    return [w["name"] for w in spec["workloads"] if w["config"] in heat]


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      manifest()["workloads"]])
def test_cell_rehearses_on_the_cpu_and_agrees_with_the_reference(workload):
    rc, result, err = rehearse(workload, trace=1)
    assert rc == 0, err[-3000:]
    assert all(k in result for k in KEYS)
    assert result["device"]["platform"] == "cpu"
    assert result["correct"] is True, result["checks"]
    checks = result["checks"]
    assert checks["saves_missing"]["value"] == 0
    # the CPU runs the same float64 arithmetic without the card's f32 sweep;
    # a von Mises field near zero carries sqrt(round-off), ~3e-8 of the
    # stress (judge.py).  A coupled cell's fixed point stops at 1e-6, a
    # hundred times looser than the momentum cells' 1e-8: 2.5e-10 of the
    # stress on the rehearsal mesh
    coupled = workload in coupled_cells()
    assert checks["fields_gap"]["value"] < 1e-7
    assert checks["state_gap"]["value"] < (1e-8 if coupled else 1e-10)
    names = ["fp_it_per_step", "krylov_it_per_step", "driver_ms", "save_ms",
             "host_reads_per_step"]
    for name in names + ["heat_cg_it_per_step"] * coupled:
        assert result["metrics"][name]["value"] > 0
    if not coupled:
        assert "heat_cg_it_per_step" not in result["metrics"]


def test_run_without_a_card_exits_non_zero_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         manifest()["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_loaded_modules_exclude_jax_and_the_reference_excludes_the_port():
    code = (
        "import sys, json; sys.path[:0] = [{b!r}, {r!r}]\n"
        "import reference.episode, reference.fem, control\n"
        "ref = sorted({{m.split('.')[0] for m in sys.modules}})\n"
        "import run, episodes, judge, devtrace, spec\n"
        "print(json.dumps([ref, sorted({{m.split('.')[0] "
        "for m in sys.modules}})]))").format(b=BENCH, r=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    ref, everything = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "safeincave_torch" not in ref
    for bad in ("jax", "jaxlib", "flax", "safeincave_tpu"):
        assert bad not in everything


def test_new_cell_config_traffic_metric_and_kernel_are_found_by_name(
        tmp_path):
    """A copy of the checkout's benchmark with one file of each kind added
    and a cell naming them: the harness runs it and reports the metric."""
    root = tmp_path / "checkout"
    root.mkdir()
    os.symlink(os.path.join(ROOT, "safeincave_torch"),
               root / "safeincave_torch")
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "cavern600_desai.json").read_text())
    cfg["name"] = "cavern600_copy"
    (b / "configs" / "cavern600_copy.json").write_text(json.dumps(cfg))
    for folder in ("configs", "reference"):
        shutil.copy(b / folder / "cavern600_desai.py",
                    b / folder / "cavern600_copy.py")
    traffic = json.loads((b / "traffic" / "daily_output.json").read_text())
    traffic.update(name="two_steps", steps=2, save_every=1)
    (b / "traffic" / "two_steps.json").write_text(json.dumps(traffic))
    (b / "metrics" / "episodes_in_window.py").write_text(
        "def read(run):\n    return float(len(run['episodes']))\n")
    (b / "kernels" / "other_action.json").write_text(json.dumps(
        {"name": "other_action", "source": "a later kernel",
         "kernels": ["other_kernel"], "per_call": "other_kernel"}))
    shutil.copy(b / "limits" / "cavern600_desai.daily_output.json",
                b / "limits" / "cavern600_copy.two_steps.json")
    spec = manifest()
    spec["configs"].append({"name": "cavern600_copy", "source": "a copy",
                            "file": "benchmark/configs/cavern600_copy.json",
                            "reduced": ["mesh"], "why": "a copy"})
    spec["workloads"].append({"name": "cavern600_copy.two_steps",
                              "config": "cavern600_copy",
                              "traffic": "two_steps", "chips": 1,
                              "why": "a copy"})
    spec["per_layer"].append({"name": "episodes_in_window", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "driver (simulators.py)",
                              "moves": "step_ms",
                              "workloads": ["cavern600_copy.two_steps"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, result, err = rehearse("cavern600_copy.two_steps", trace=1,
                               root=str(root))
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["episodes_in_window"]["value"] >= 1


def test_alone_the_benchmark_exits_non_zero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rc, result, _ = rehearse(manifest()["workloads"][0]["name"],
                             root=str(tmp_path))
    assert rc != 0 and result is None


# each fault is applied once the set-up is done, so that the timed path
# (the episodes) runs broken underneath an intact harness
FAULTS = {
    # a step that returns its state unchanged
    "state_unchanged": """
from safeincave_torch.fem.momentum import LinearMomentum
import numpy as np
def steps(self, ts, dts, tol=1e-8, maxiter=40):
    return np.array([[3, 0.0, 10, 3, 0.0, 1.0]] * len(ts))
def step(self, t, dt, tol=1e-8, maxiter=40):
    return 3, 0.0
LinearMomentum.solve_time_steps = steps
LinearMomentum.solve_time_step = step
""",
    # an answer altered where it is produced: one saved displacement
    "answer_altered": """
from safeincave_torch.output.xdmf import SaveFields
real = SaveFields._get_field
def get(self, name):
    a = real(self, name).copy()
    if name == "u":
        a[len(a) // 2] *= 1.001
    return a
SaveFields._get_field = get
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    """The harness runs whole, with the timed path broken underneath after
    set-up, and ``correct`` comes out false.  Half a batch and the exchange
    between chips do not exist in these one-card cells."""
    prelude = (
        "import episodes\n"
        "_setup = episodes.Cell.setup\n"
        "def setup(self):\n"
        "    _setup(self)\n"
        f"    exec({FAULTS[fault]!r}, {{}})\n"
        "episodes.Cell.setup = setup\n")
    rc, result, err = rehearse(manifest()["workloads"][0]["name"],
                               prelude=prelude)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]


def test_the_control_is_not_correct(tmp_path):
    """The float32 reference in the program's place fails a limit of every
    cell's configuration, on a cavern mesh of 1,049 nodes: the float32
    error grows with the mesh, and on the 4-cell rehearsal mesh (175
    nodes) the nobian control reads 2.6e-6 to 5.5e-6 against the limit
    3e-6, with the thread count; here 1.0e-5 (4.6e-4 on the card's
    mesh)."""
    sys.path[:0] = [BENCH, ROOT]
    import control
    import run
    from judge import gap  # noqa: F401
    mesh = os.path.join(run.rehearsal_mesh(str(tmp_path), n=8), "geom.msh")
    spec = manifest()
    for w in spec["workloads"]:
        with open(os.path.join(BENCH, "limits", f"{w['name']}.json")) as f:
            limits = json.load(f)
        from reference.episode import reference
        from spec import load_json, start_hours
        import torch
        cfg = load_json("configs", f"{w['config']}.json")
        traffic = dict(load_json("traffic", f"{w['traffic']}.json"))
        start = start_hours(cfg, 0)
        ref = reference(cfg, traffic, mesh, start, torch.float64, "cpu",
                        ROOT)
        ctl = reference(cfg, traffic, mesh, start, torch.float32, "cpu",
                        ROOT, strict=False)
        numbers = control.control_numbers(ctl, ref)
        assert any(not v <= limits[k] for k, v in numbers.items()), \
            (w["name"], numbers, limits)
        assert np.isfinite(ref["state"]["u"]).all()


def test_device_trace_busy_time_gaps_and_idle_share():
    """The union of device intervals, the idle gaps with what the host was
    doing, and idle_pct read against the episode run without the
    profiler."""
    sys.path[:0] = [BENCH, ROOT]
    import devtrace
    from spec import load_module
    ms = 1_000_000
    dev = [(0, 4 * ms, "k1"), (2 * ms, 5 * ms, "k2"), (9 * ms, 10 * ms, "k1"),
           (12 * ms, 13 * ms, "k2")]
    host = [(4 * ms, 6 * ms, "cudaStreamSynchronize"),
            (6 * ms, 10 * ms, "cudaGraphLaunch")]
    out = devtrace.summarize(dev, host, window_s=0.020)
    assert out["busy_s"] == pytest.approx(0.007)
    assert out["kernels"]["k1"] == [2, pytest.approx(0.005)]
    assert out["idle_gaps"] == [["in cudaGraphLaunch", pytest.approx(0.004)],
                                ["cudaGraphLaunch -> end",
                                 pytest.approx(0.002)]]
    idle = load_module(os.path.join(BENCH, "metrics", "idle_pct.py"),
                       "idle_pct_reader")
    run = {"trace": {"profile": {**out, "plain_s": 0.010}}}
    assert idle.read(run) == pytest.approx(30.0)
    assert idle.read({"trace": {"profile": None}}) is None
