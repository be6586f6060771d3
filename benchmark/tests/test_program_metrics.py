"""CPU test of the per-layer metrics that read the program's own spans and
counters (``safeincave_torch.tracing``, through ``program_runs.py``): one
``--trace 1`` rehearsal of ``cavern600_desai.daily_output`` with a 20 s
window (two episodes where the machine runs one in under 20 s).

    python -m pytest -q benchmark/tests/test_program_metrics.py

On the CPU the program counts the same reads as the frozen patch of the
tensor's read methods, the host-clock readers give positive numbers, and
the readers of device spans and gaps give nothing.
"""
import builtins
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

from test_benchmark_harness import BENCH, ROOT

CELL = "cavern600_desai.daily_output"
HOST = ("driver_self_ms", "save_span_ms", "reads_per_step", "setup_precond_s")
DEVICE = ("tangent_dev_ms", "solve_dev_ms", "host_gap_ms", "setup_capture_s")
# reads the window's records too; 0 on the CPU, whose "auto" is 2level
# (test_precond_applies_per_step.py)
COUNTERS = ("precond_applies_per_step",)

# logs what the readers' window selection found, beside the episodes
PRELUDE = """
import sys
import program_runs
_real = program_runs.window_runs
def _logged(run):
    out = _real(run)
    print("window_runs", len(run["episodes"]),
          -1 if out is None else len(out),
          len({id(r) for r in out or ()}),
          sum(len(e["stamps"]) for e in run["episodes"]), file=sys.stderr)
    return out
program_runs.window_runs = _logged
"""


@pytest.fixture(scope="module")
def traced():
    """(result line, stderr) of the rehearsal."""
    run_py = os.path.join(BENCH, "run.py")
    argv = [run_py, "--workload", CELL, "--seed", "1510000001",
            "--seconds", "20", "--trace", "1", "--rehearse-cpu"]
    code = (f"import sys, runpy\n"
            f"sys.path[:0] = [{os.path.dirname(run_py)!r}, {ROOT!r}]\n"
            f"{PRELUDE}\n"
            f"sys.argv = {argv!r}\n"
            f"runpy.run_path({run_py!r}, run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900, cwd=ROOT,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


def test_reads_per_step_is_the_patched_count(traced):
    result, _ = traced
    m = result["metrics"]
    assert result["correct"]
    assert m["reads_per_step"]["value"] == m["host_reads_per_step"]["value"]
    assert m["reads_per_step"]["unit"] == "reads/step"


@pytest.mark.parametrize("name", HOST)
def test_host_readers_give_positive_numbers(traced, name):
    assert traced[0]["metrics"][name]["value"] > 0


@pytest.mark.parametrize("name", DEVICE)
def test_device_readers_give_nothing_on_the_cpu(traced, name):
    assert name not in traced[0]["metrics"]


def test_window_runs_match_one_for_one(traced):
    """Every reader found one record per window episode, no two episodes
    sharing one, among the records of the warm stages, the episode before
    the window and the window."""
    _, err = traced
    found = [tuple(map(int, line.split()[1:]))
             for line in err.splitlines() if line.startswith("window_runs")]
    assert len(found) == len(HOST) + len(DEVICE) + len(COUNTERS)
    for episodes, records, distinct, stamps in found:
        assert episodes == records == distinct >= 1
        assert stamps >= episodes
    assert re.search(rf", {found[0][0]} episodes,", err)


def test_without_the_tracer_readers_give_nothing(monkeypatch):
    """A program without ``safeincave_torch.tracing`` gives no record,
    and the window selection does not raise."""
    spec = importlib.util.spec_from_file_location(
        "program_runs", os.path.join(BENCH, "program_runs.py"))
    program_runs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(program_runs)
    real = builtins.__import__

    def no_tracer(name, *args, **kw):
        if name == "safeincave_torch" and "tracing" in (args[2] or ()):
            raise ImportError("no tracer")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tracer)
    run = {"episodes": [{"stamps": [1.0]}]}
    assert program_runs.window_runs(run) is None
