"""CPU tests of the reader ``metrics/f64_action_per_step.py``: the band
kernel's ``band64_launches`` counter deltas per converged step of the
window, through ``program_runs.py``.

    python -m pytest -q benchmark/tests/test_f64_action_per_step.py

On the CPU the f64 action stays on the cumsum matvec, so a rehearsal reads
0; synthetic run records check the arithmetic, and a program without the
counter (or without the tracer) gives nothing.
"""
import builtins
import importlib.util
import os
import sys

import pytest

from test_benchmark_harness import BENCH, rehearse

NAME = "f64_action_per_step"
CELL = "nobian_interlayer1200.operation"


def _reader():
    sys.path.insert(0, BENCH)
    try:
        spec = importlib.util.spec_from_file_location(
            NAME, os.path.join(BENCH, "metrics", f"{NAME}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(BENCH)
    return module


def _records():
    return [{"start_ns": 0, "end_ns": 10, "steps": 4,
             "counters": {"band64_launches": 210, "replays": 9}},
            {"start_ns": 20, "end_ns": 30, "steps": 4,
             "counters": {"band64_launches": 222, "replays": 9}}]


RUN = {"episodes": [{"stamps": [5e-9]}, {"stamps": [25e-9]}]}


def test_reads_the_counter_per_converged_step(monkeypatch):
    """(210 + 222) launches over 8 converged steps."""
    from safeincave_torch import tracing
    monkeypatch.setattr(tracing, "runs", _records())
    assert _reader().read(RUN) == 54.0


@pytest.mark.parametrize("case", ["counter_absent", "no_window_record",
                                  "no_steps", "no_tracer"])
def test_gives_nothing_without_its_counter(monkeypatch, case):
    """The parent of the kernel has no ``band64_launches``; a window whose
    episodes hold no record, or no converged step, or a program without
    ``safeincave_torch.tracing``, gives nothing and does not raise."""
    from safeincave_torch import tracing
    recs = _records()
    if case == "counter_absent":
        for r in recs:
            del r["counters"]["band64_launches"]
    elif case == "no_window_record":
        recs = recs[:1]
    elif case == "no_steps":
        for r in recs:
            r["steps"] = 0
    monkeypatch.setattr(tracing, "runs", recs)
    reader = _reader()
    if case == "no_tracer":
        real = builtins.__import__

        def no_tracer(name, *args, **kw):
            if name == "safeincave_torch" and "tracing" in (args[2] or ()):
                raise ImportError("no tracer")
            return real(name, *args, **kw)

        monkeypatch.setattr(builtins, "__import__", no_tracer)
    assert reader.read(RUN) is None


def test_reads_zero_in_a_cpu_rehearsal():
    """A traced rehearsal of a cell that lists the metric: on the CPU the
    f64 action never launches the band kernel."""
    rc, result, err = rehearse(CELL, seed=1510000003, trace=1)
    assert rc == 0, err[-3000:]
    assert result["correct"]
    assert result["metrics"][NAME] == {"value": 0.0,
                                       "unit": "launches/step"}
