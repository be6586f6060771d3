"""CPU tests of the reader ``metrics/mc_yield_pct.py``: the Mohr-Coulomb
elements on the yield surface over the elements that can flow, from the
``mc_yield_elems`` and ``mc_elem_steps`` counter deltas of the window's
run records, through ``program_runs.py``.

    python -m pytest -q benchmark/tests/test_mc_yield_pct.py

Synthetic run records check the arithmetic; a program without the
counters (or without the tracer), a window without records and one
without converged steps give nothing; so does a traced rehearsal of a
momentum cell without Mohr-Coulomb elements.
"""
import builtins
import importlib.util
import os
import sys

import pytest

from test_benchmark_harness import BENCH, rehearse

NAME = "mc_yield_pct"
CELL = "cavern600_desai.daily_output"


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
    # 1,000 elements can flow; 24 converged steps in each record
    return [{"start_ns": 0, "end_ns": 10, "steps": 24,
             "counters": {"mc_yield_elems": 6_000, "mc_elem_steps": 24_000,
                          "replays": 9}},
            {"start_ns": 20, "end_ns": 30, "steps": 24,
             "counters": {"mc_yield_elems": 6_480, "mc_elem_steps": 24_000,
                          "replays": 9}}]


RUN = {"episodes": [{"stamps": [5e-9]}, {"stamps": [25e-9]}]}


def test_reads_the_yield_share_of_the_window(monkeypatch):
    """(6,000 + 6,480) yielding element-steps of 48,000."""
    from safeincave_torch import tracing
    monkeypatch.setattr(tracing, "runs", _records())
    assert _reader().read(RUN) == pytest.approx(26.0)


@pytest.mark.parametrize("case", ["counter_absent", "denominator_absent",
                                  "no_window_record", "no_steps",
                                  "no_mohr_coulomb", "no_tracer"])
def test_gives_nothing_without_its_counters(monkeypatch, case):
    """The parent has no such counters; a window whose episodes hold no
    record, or no converged step, or no element that can flow, or a
    program without ``safeincave_torch.tracing``, gives nothing and does
    not raise."""
    from safeincave_torch import tracing
    recs = _records()
    if case == "counter_absent":
        del recs[1]["counters"]["mc_yield_elems"]
    elif case == "denominator_absent":
        del recs[0]["counters"]["mc_elem_steps"]
    elif case == "no_window_record":
        recs = recs[:1]
    elif case == "no_steps":
        for r in recs:
            r["steps"] = 0
            r["counters"].update(mc_yield_elems=0, mc_elem_steps=0)
    elif case == "no_mohr_coulomb":
        for r in recs:
            r["counters"].update(mc_yield_elems=0, mc_elem_steps=0)
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


# reads the window with the reader beside the others, once, and logs it
PRELUDE = """
import sys
import program_runs
from spec import BENCH, load_module
import os
_real = program_runs.window_runs
_reader = load_module(os.path.join(BENCH, "metrics", "mc_yield_pct.py"),
                      "mc_yield_pct_logged")
_done = []
def _logged(run):
    out = _real(run)
    if not _done:
        _done.append(1)
        print("mc_yield_pct", repr(_reader.read(run)),
              -1 if out is None else len(out), file=sys.stderr)
    return out
program_runs.window_runs = _logged
"""


def test_a_momentum_cell_without_mohr_coulomb_gives_nothing():
    """A traced rehearsal of the Desai cavern, the reader run on its window:
    one record per episode, no element that can flow, nothing read."""
    rc, result, err = rehearse(CELL, seed=1510000003, trace=1,
                               prelude=PRELUDE)
    assert rc == 0, err[-3000:]
    assert result["correct"]
    assert NAME not in result["metrics"]
    logged = [line.split()[1:] for line in err.splitlines()
              if line.startswith("mc_yield_pct ")]
    assert logged and logged[0][0] == "None" and int(logged[0][1]) >= 1
