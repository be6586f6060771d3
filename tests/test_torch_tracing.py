"""safeincave_torch.tracing on the CPU: spans, self time, gaps, the ring,
run records, the switch and the Chrome export on an injected clock; then a
small ``Simulator_M`` run, whose own read count must equal a count made by
patching the tensor's read methods, and whose fused-chunk ``wall_s`` are
each step's own span.

The benchmark's window selection (``benchmark/program_runs.py``) is held
here too, on records made by the tracer: one record per window episode,
chosen by the episodes' save stamps.
"""
import importlib.util
import json
import os

import pytest
import torch

import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_torch import tracing
from safeincave_torch.tracing import (CHUNK, FIXED_POINT, GAP, HEAT, KRYLOV,
                                      NONE, READ, REPLAY, RUN, SAVE, STEP,
                                      Tracer)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Clock:
    """A clock the test sets: ``clock.t = ...``."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


class Stats:
    """Stands in for a packed stats tensor on a CUDA or CPU device."""

    def __init__(self, vals, cuda=True):
        self.vals, self.is_cuda = vals, cuda

    def tolist(self):
        return list(self.vals)


def tracer(**kw):
    clock = Clock()
    return Tracer(clock=clock, offset_ns=0, **kw), clock


def at(clock, t, fn, *args):
    clock.t = t
    return fn(*args)


def test_nesting_and_self_time():
    tr, c = tracer()
    at(c, 0, tr.begin, RUN)
    at(c, 10, tr.begin, STEP)
    at(c, 12, tr.begin, READ)
    at(c, 15, tr.end, READ)
    at(c, 20, tr.end, STEP)
    at(c, 30, tr.end, RUN)
    spans = tr.totals()["spans"]
    assert spans["run"] == {"count": 1, "total_ns": 30, "self_ns": 20}
    assert spans["step"] == {"count": 1, "total_ns": 10, "self_ns": 7}
    assert spans["read"] == {"count": 1, "total_ns": 3, "self_ns": 3}
    # the ring: (name, start, end, parent, step), closed order
    assert tr.spans() == [(READ, 12, 15, STEP, 0), (STEP, 10, 20, RUN, 0),
                          (RUN, 0, 30, NONE, 0)]
    assert tr.take_walls() == [10] and tr.take_walls() == []


def test_end_closes_spans_an_exception_left_open():
    tr, c = tracer()
    at(c, 0, tr.begin, CHUNK)
    at(c, 1, tr.begin, STEP)
    at(c, 2, tr.begin, FIXED_POINT)
    at(c, 5, tr.end, CHUNK)              # step and fixed point never ended
    assert [s[0] for s in tr.spans()] == [FIXED_POINT, STEP, CHUNK]
    assert tr.stack == []
    at(c, 6, tr.end, SAVE)               # never begun: ignored
    assert len(tr.spans()) == 3


def test_gap_is_keyed_by_the_innermost_span():
    """A CUDA read opens a gap at its return; each piece of it goes to the
    span that held the host; an enqueue closes it."""
    tr, c = tracer()
    at(c, 0, tr.begin, STEP)
    at(c, 1, tr.begin, KRYLOV)
    assert at(c, 2, tr.read, Stats([0.0, 4.0])) == [0.0, 4.0]
    assert tr.gap_t0 == 2                # the fake read takes no time
    at(c, 5, tr.end, KRYLOV)             # 3 ns of gap in the Krylov loop
    at(c, 6, tr.begin, FIXED_POINT)      # 1 ns in the step
    at(c, 9, tr.enqueue)                 # 3 ns in the fixed point
    assert tr.gap_t0 is None
    gaps = tr.totals()["gaps"]
    assert gaps == {"krylov": 3, "step": 1, "fixed_point": 3}
    assert (GAP, 2, 9, KRYLOV, 0) in tr.spans()
    # a replay's launch is an enqueue (the launch is the replay's piece);
    # a CPU read opens nothing
    at(c, 10, tr.read, Stats([1.0]))
    at(c, 14, tr.begin, REPLAY)
    at(c, 15, tr.replay_end)
    at(c, 16, tr.read, Stats([1.0], cuda=False))
    at(c, 30, tr.enqueue)
    assert tr.totals()["gaps"]["fixed_point"] == 3 + 4
    assert tr.totals()["gaps"]["replay"] == 1
    assert (GAP, 10, 15, FIXED_POINT, 0) in tr.spans()
    assert tr.totals()["spans"]["gap"]["count"] == 2
    at(c, 40, tr.begin, REPLAY)         # a replay with no gap open
    at(c, 45, tr.replay_end)
    assert tr.totals()["spans"]["gap"]["count"] == 2
    assert tr.totals()["spans"]["replay"]["count"] == 2
    # a read into an open gap ends it when the read starts
    at(c, 31, tr.read, Stats([1.0]))
    at(c, 35, tr.read, Stats([1.0]))
    assert tr.totals()["gaps"]["fixed_point"] == 3 + 4 + 4


def test_a_heat_span_keeps_the_gaps_inside_it():
    """The heat step's CG loop and its reads run inside a ``heat`` span: the
    gaps there go to ``heat``, and to the innermost span again once the
    heat span has closed."""
    tr, c = tracer()
    at(c, 0, tr.begin, STEP)
    at(c, 1, tr.begin, HEAT)
    at(c, 2, tr.begin, KRYLOV)
    at(c, 3, tr.read, Stats([1.0]))       # opens a gap held by heat
    at(c, 7, tr.end, KRYLOV)              # 4 ns in the heat's CG loop
    at(c, 9, tr.enqueue)                  # 2 ns in the heat step itself
    assert (GAP, 3, 9, HEAT, 0) in tr.spans()
    at(c, 10, tr.read, Stats([1.0]))
    at(c, 12, tr.end, HEAT)               # 2 ns, heat
    at(c, 13, tr.begin, KRYLOV)           # 1 ns, step
    at(c, 20, tr.enqueue)                 # 7 ns, a momentum Krylov loop
    assert tr.totals()["gaps"] == {"heat": 8, "step": 1, "krylov": 7}
    assert tr.heat_open == 0


def test_ring_wraps_around():
    tr, c = tracer(ring=4)
    for k in range(6):
        at(c, 10 * k, tr.begin, STEP)
        at(c, 10 * k + 5, tr.end, STEP)
    spans = tr.spans()
    assert [s[1] for s in spans] == [20, 30, 40, 50]
    assert tr.totals()["spans"]["step"]["count"] == 6


def _load_program_runs():
    path = os.path.join(ROOT, "benchmark", "program_runs.py")
    spec = importlib.util.spec_from_file_location("program_runs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_records_and_window_selection(monkeypatch):
    tr, c = tracer()
    counts = {"replays": 0, "captures": 0}
    records = []
    for k in range(4):                  # 4 runs of 100 ns, 2 steps each
        t0 = 1000 * k
        at(c, t0, tr.open_run, lambda: dict(counts), True)
        counts["replays"] += 3
        if k == 0:
            tr.captured(("call", ("tangent", 3600.0, 0.5)))
            counts["captures"] += 1
        at(c, t0 + 10, tr.read, Stats([0.0]))
        at(c, t0 + 40, tr.begin, SAVE)
        at(c, t0 + 60, tr.end, SAVE)
        at(c, t0 + 100, tr.close_run, 2)
        records.append(tr.runs[-1])
    first, second = records[:2]
    assert first["start_ns"] == 0 and first["end_ns"] == 100
    assert first["steps"] == 2 and first["cuda"] and first["completed"]
    assert first["counters"] == {"replays": 3, "captures": 1}
    assert second["counters"] == {"replays": 3, "captures": 0}
    assert first["captures"] == ["('call', ('tangent', 3600.0, 0.5))"]
    assert second["captures"] == []
    assert first["spans"]["run"] == {"count": 1, "total_ns": 100,
                                     "self_ns": 80}
    # the run opens a gap, the read ends it and opens another to the end
    assert first["gaps"] == {"run": 10 + 70, "save": 20}
    assert first["setup"]["spans"]["save"]["count"] == 0
    assert second["setup"]["spans"]["save"]["count"] == 1

    program_runs = _load_program_runs()
    monkeypatch.setattr(tracing, "runs", tr.runs)
    run = {"episodes": [{"stamps": [1.05e-6]}, {"stamps": [2.05e-6]}]}
    assert program_runs.window_runs(run) == records[1:3]
    # an episode with no record of its own, or two episodes in one record
    assert program_runs.window_runs(
        {"episodes": [{"stamps": [5e-6]}]}) is None
    assert program_runs.window_runs(
        {"episodes": [{"stamps": [1.01e-6]}, {"stamps": [1.09e-6]}]}) is None
    assert program_runs.span(records[1:3], "read") == (2, 0)
    assert program_runs.steps(records) == 8


def test_disabled_records_nothing():
    tr, c = tracer()
    tr.enable(False)
    at(c, 0, tr.open_run, lambda: {"replays": 0}, True)
    at(c, 1, tr.begin, STEP)
    assert at(c, 2, tr.read, Stats([3.0])) == [3.0]
    at(c, 3, tr.end, STEP)
    at(c, 4, tr.begin, REPLAY)
    at(c, 5, tr.replay_end)
    assert tr.dev_begin(torch.device("cpu")) is None
    at(c, 9, tr.close_run, 1)
    assert tr.spans() == [] and len(tr.runs) == 0
    assert all(v == {"count": 0, "total_ns": 0, "self_ns": 0}
               for v in tr.totals()["spans"].values())
    assert tr.take_walls() == []
    tr.enable(True)
    at(c, 10, tr.begin, STEP)
    at(c, 12, tr.end, STEP)
    assert tr.count_of("step") == 1


def test_device_spans_are_not_recorded_on_the_cpu():
    tr, _ = tracer()
    pair = tr.dev_begin(torch.device("cpu"))
    assert pair is None
    tr.dev_end("tangent", pair)
    assert not tr.pending
    assert tr.totals()["device"]["tangent"] == {"count": 0, "ms": 0.0}


def test_chrome_export_carries_the_offset(tmp_path):
    clock = Clock()
    tr = Tracer(clock=clock, offset_ns=5_000_000)
    at(clock, 1000, tr.begin, STEP)
    at(clock, 1500, tr.read, Stats([0.0]))
    at(clock, 3000, tr.end, STEP)
    at(clock, 4000, tr.enqueue)
    path = tmp_path / "trace.json"
    tr.write_chrome(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    by_name = {e["name"]: e for e in events if e["ph"] == "X"}
    assert by_name["step"]["ts"] == pytest.approx((1000 + 5_000_000) / 1e3)
    assert by_name["step"]["dur"] == pytest.approx(2.0)
    assert by_name["read"]["args"] == {"step": 0, "parent": "step"}
    assert by_name["gap"]["ts"] == pytest.approx((1500 + 5_000_000) / 1e3)
    assert by_name["gap"]["args"]["cause"] == "step"
    assert by_name["gap"]["tid"] != by_name["step"]["tid"]
    tr.write_chrome(str(path), since_ns=3500)     # the gap alone
    events = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in events if e["ph"] == "X"] == ["gap"]


def test_the_import_offset_is_the_wall_clock_shift():
    """The singleton's offset turns perf_counter_ns into time.time_ns, the
    clock torch.profiler's timestamps use."""
    import time
    shift = time.time_ns() - time.perf_counter_ns()
    assert abs(tracing.TRACER.offset_ns - shift) < 50_000_000


# -- a small run of the program --------------------------------------------- #
READS = ("item", "tolist", "__float__", "__int__", "__bool__")


class PatchedReads:
    """Counts the host reads of tensors (a read inside another counts
    once) by patching the tensor's read methods while active."""

    def __enter__(self):
        self.n, depth = 0, [0]
        self.saved = {k: getattr(torch.Tensor, k) for k in READS}

        def counted(f):
            def read(t, *a, **kw):
                self.n += depth[0] == 0
                depth[0] += 1
                try:
                    return f(t, *a, **kw)
                finally:
                    depth[0] -= 1
            return read

        for k, f in self.saved.items():
            setattr(torch.Tensor, k, counted(f))
        return self

    def __exit__(self, *exc):
        for k, f in self.saved.items():
            setattr(torch.Tensor, k, f)


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    """Six 1 h steps of the small Kelvin-Voigt box through Simulator_M: a
    save every 3 steps and a checkpoint every 3, so steps 1-3 and 4-6 run
    as fused chunks; returns (run record, StepMetrics rows, patched read
    count, program read count)."""
    folder = str(tmp_path_factory.mktemp("traced"))
    eq = cfg.small_box(st, "cpu", kelvin=True)
    tc = st.TimeController(dt=1.0, initial_time=0.0, final_time=6.0,
                           time_unit="hour")
    out = st.SaveFields(eq, save_every=3)
    out.set_output_folder(folder)
    out.add_output_field("u", "u")
    metrics = st.StepMetrics()
    sim = st.Simulator_M(eq, tc, [out], metrics=metrics, checkpoint_every=3,
                         checkpoint_path=os.path.join(folder, "ckpt.npz"))
    n0 = tracing.count_of("read")
    with PatchedReads() as patched:
        sim.run()
    return (tracing.runs[-1], metrics.records, patched.n,
            tracing.count_of("read") - n0, eq)


def test_program_reads_equal_patched_reads(small_run):
    record, _, patched, program, _ = small_run
    assert program == patched > 0
    assert record["spans"]["read"]["count"] == program


def test_fused_wall_s_are_each_steps_own_span(small_run):
    record, rows, _, _, _ = small_run
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5, 6]
    assert all(r["fused"] for r in rows)
    assert set(rows[0]) == {"step", "t", "dt", "fp_iters", "error", "wall_s",
                            "fused", "converged", "dt_cuts", "krylov",
                            "krylov_total", "lin_res"}
    walls = [r["wall_s"] for r in rows]
    assert len(set(walls)) == len(walls)
    chunk = record["spans"]["chunk"]
    assert chunk["count"] == 2
    assert sum(walls) <= 1e-9 * chunk["total_ns"]
    steps = record["spans"]["step"]
    assert steps["count"] == 6
    assert sum(walls) == pytest.approx(1e-9 * steps["total_ns"], rel=1e-9)


def test_run_record_of_a_cpu_run(small_run):
    record, rows, _, _, eq = small_run
    assert record["steps"] == 6 and record["completed"]
    assert not record["cuda"] and record["gaps"] == {}
    spans = record["spans"]
    assert spans["save"]["count"] == 3       # t = 0, steps 3 and 6
    assert spans["checkpoint"]["count"] == 2
    assert spans["commit"]["count"] == 6
    assert spans["fixed_point"]["count"] == 6
    assert spans["krylov"]["count"] >= 6
    assert "replay" not in spans and "capture" not in spans
    c = record["counters"]
    assert c["fp_iterations"] == sum(r["fp_iters"] for r in rows)
    assert c["krylov_iterations"] == sum(r["krylov_total"] for r in rows)
    assert c["replays"] == c["captures"] == 0
    assert record["device"] == {"tangent": [], "solve": []}
    assert record["captures"] == []
    assert record["start_ns"] < record["end_ns"]
    assert eq.counters()["fp_iterations"] == eq.fp_iterations_total
