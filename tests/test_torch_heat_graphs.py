"""The heat step from captured CUDA graphs (safeincave_torch/fem/heat.py):

- on the card, three heat steps of the heated cube (a Robin wall, a
  Dirichlet ramp, a Neumann flux, two values of dt) through the captured
  path and under ``graphs.eager()``, in both precisions: ``T``, the CG
  counts and the residuals equal bit for bit, the set-up and the CG blocks
  captured once and replayed after (an operator that closed over a tensor
  of one step would replay that step's data in the next);
- on the CPU, the boundary arrays the step builds from the conditions'
  device tables and scalars against the handler's host arrays over a
  ramp's times (mask and ``T_bc`` exactly, the facet loads to a few ulps);
- the ``heat_replays`` counter of ``Simulator_TM``'s run record and its
  reader ``benchmark/metrics/heat_replays_per_step.py``.

The file imports no JAX, so the card's test runs on the machine with it:

    python -m pytest --noconftest -m gpu tests/test_torch_heat_graphs.py

(``--noconftest``: tests/conftest.py sets JAX up for the rest of the
suite.)  Without a CUDA device that test skips.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_torch import tracing
from safeincave_torch.fem import graphs

torch.set_num_threads(1)

HOUR = cfg.HOUR
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
READER = "heat_replays_per_step"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU, see the module "
                    "docstring)")
    return torch.device("cuda")


def _conditions(heat):
    """A handler on the cube: Dirichlet ramps on TOP and then EAST (they
    share an edge, where EAST's value wins), a Neumann flux on WEST, Robin
    walls on BOTTOM and NORTH, each value ramping over [0, 4 h]."""
    bc = st.HeatBC
    tv = [0.0, 4 * HOUR]
    h = bc.BcHandler(heat)
    h.add_boundary_condition(bc.DirichletBC("TOP", [298.0, 330.0], tv))
    h.add_boundary_condition(bc.DirichletBC("EAST", [300.0, 290.0], tv))
    h.add_boundary_condition(bc.NeumannBC("WEST", [2.0, -3.5], tv))
    h.add_boundary_condition(bc.RobinBC("BOTTOM", [298.0, 283.0], 25.0, tv))
    h.add_boundary_condition(bc.RobinBC("NORTH", [310.0, 305.0], 5.0, tv))
    return h


def _heat(device, precision):
    _, heat = cfg.tm_cube(st, device)
    heat.set_boundary_conditions(_conditions(heat))
    heat.set_solver(st.SolverSettings(method="cg", rtol=1e-12, max_it=500,
                                      precision=precision))
    return heat


STEPS = ((HOUR, HOUR), (2 * HOUR, HOUR), (2.5 * HOUR, 0.5 * HOUR))


def _three_steps(heat):
    """The three steps' (T, iterations, residual), and the graphs captured
    after each step."""
    T, out, captures = heat.T, [], []
    for t, dt in STEPS:
        T, iters, res = heat.step(T, T, t, dt)
        out.append((T, iters, res))
        captures.append(heat.graphs.captures)
    return out, captures


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["mixed", "f64"])
def test_captured_heat_steps_equal_eager_bitwise(cuda, precision):
    heat = _heat(cuda, precision)
    g = heat.graphs
    captured, captures = _three_steps(heat)
    with graphs.eager():
        eager, none = _three_steps(_heat(cuda, precision))
    assert none == [0, 0, 0]
    for k, ((T, it, res), (T_e, it_e, res_e)) in enumerate(zip(captured,
                                                              eager)):
        assert torch.equal(T, T_e), k
        assert it == it_e > 0 and res == res_e, k
    # captured in the first step alone: the set-up, the operator of the
    # solver's start in each precision it uses and the block; a new dt
    # enters through coef and captures nothing
    assert captures == [4 if precision == "mixed" else 3] * 3
    assert g.replays > 3 * captures[0]
    assert float((captured[-1][0] - captured[0][0]).abs().max()) > 0.1


# -- the boundary arrays, on the CPU ---------------------------------------- #
def test_device_tables_give_the_host_arrays():
    heat = _heat("cpu", "mixed")
    bc = heat.bc
    tables = bc.tables()
    assert tables["loads"].shape == (3, heat.n_nodes)
    eps = np.finfo(np.float64).eps
    for t in np.linspace(-HOUR, 5 * HOUR, 13):
        vals = torch.tensor(bc.values(t), dtype=torch.float64)
        mask, T_bc, load = bc.step_arrays(vals, tables)
        want_mask, want_T = bc.dirichlet_arrays(t)
        assert torch.equal(mask, want_mask)
        assert torch.equal(T_bc, want_T)
        want = bc.neumann_rhs(t) + bc.robin_rhs(t)
        scale = float(want.abs().max())
        assert scale > 0
        assert float((load - want).abs().max()) <= 8 * eps * scale, t


def test_tables_follow_a_condition_added_later():
    heat = _heat("cpu", "mixed")
    bc = heat.bc
    n_vals = len(bc.values(0.0))
    first = bc.tables()
    bc.add_boundary_condition(st.HeatBC.NeumannBC("SOUTH", [1.0, 1.0],
                                                  [0.0, HOUR]))
    assert len(bc.values(0.0)) == n_vals + 1
    again = bc.tables()
    assert again is not first and again["loads"].shape[0] == 4
    assert bc.tables() is again          # built once per set of conditions


# -- the run record's counter and its reader -------------------------------- #
def _reader():
    sys.path.insert(0, BENCH)
    try:
        spec = importlib.util.spec_from_file_location(
            READER, os.path.join(BENCH, "metrics", f"{READER}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(BENCH)
    return module


def test_simulator_tm_records_carry_heat_replays():
    """A ``Simulator_TM`` record has ``heat_replays`` (0 on the CPU, where
    nothing is captured); a ``Simulator_M`` record does not."""
    eq, heat = cfg.tm_cube(st, "cpu")
    t0 = tracing.now()
    tc = st.TimeController(dt=1.0, initial_time=0.0, final_time=2.0,
                           time_unit="hour")
    st.Simulator_TM(eq, heat, tc, []).run()
    tc = st.TimeController(dt=1.0, initial_time=2.0, final_time=3.0,
                           time_unit="hour")
    st.Simulator_M(eq, tc, []).run()
    tm, m = [r for r in tracing.runs if r["start_ns"] > t0]
    assert tm["steps"] == 2 and tm["counters"]["heat_replays"] == 0
    assert "heat_replays" not in m["counters"]
    assert set(m["counters"]) == set(tm["counters"]) - {"heat_replays"}


def _records():
    return [{"start_ns": 0, "end_ns": 10, "steps": 4,
             "counters": {"heat_replays": 50, "replays": 9}},
            {"start_ns": 20, "end_ns": 30, "steps": 4,
             "counters": {"heat_replays": 54, "replays": 9}}]


RUN = {"episodes": [{"stamps": [5e-9]}, {"stamps": [25e-9]}]}


@pytest.mark.parametrize("case", ["counted", "counter_absent", "no_steps"])
def test_reader_reads_the_counter_or_nothing(monkeypatch, case):
    """(50 + 54) replays over 8 converged steps; a program without the
    counter (one older than the captured heat step) or a window without a
    converged step gives nothing."""
    recs = _records()
    if case == "counter_absent":
        for r in recs:
            del r["counters"]["heat_replays"]
    elif case == "no_steps":
        for r in recs:
            r["steps"] = 0
    monkeypatch.setattr(tracing, "runs", recs)
    want = 13.0 if case == "counted" else None
    assert _reader().read(RUN) == want
