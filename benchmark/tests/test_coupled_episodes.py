"""CPU tests of the coupled (thermo-mechanical) episodes: the plain heat
step against the program's, the faults a coupled cell can have, the
traffic a coupled cell refuses, and the momentum cells' counts through the
recorder as they were before it learned the coupled calls.

    python -m pytest -q benchmark/tests/test_coupled_episodes.py
"""
import os
import sys

import numpy as np
import pytest

from test_benchmark_harness import (BENCH, ROOT, coupled_cells, manifest,
                                    rehearse)

TM = "regular1200_tm.cyclic"


def test_plain_heat_step_equals_the_program_heat_step(tmp_path):
    """Three backward-Euler steps of the plain reference and of the
    program's ``HeatDiffusion.step`` in float64 CG, from the same start, on
    the rehearsal mesh: within 1e-10 of max|T| at every step."""
    sys.path[:0] = [BENCH, ROOT]
    import torch
    import run
    from judge import match
    from reference.heat import Heat
    from reference.mesh import Mesh
    from spec import load_json, load_module
    cfg = load_json("configs", "regular1200_tm.json")
    cfg["heat"]["solver"] = dict(cfg["heat"]["solver"], precision="f64")
    folder = run.rehearsal_mesh(str(tmp_path))
    builder = load_module(os.path.join(BENCH, "configs",
                                       "regular1200_tm.py"), "tm_builder")
    _, heat = builder.build(cfg, folder, "cpu")
    assert heat.bc.dirichlet_boundaries and heat.bc.robin_boundaries
    mesh = Mesh(os.path.join(folder, "geom.msh"))
    ref = Heat(mesh, cfg, torch.float64, "cpu")
    node, _ = match(np.asarray(heat.grid.points), np.asarray(heat.grid.conn),
                    mesh.points, mesh.tets)
    T = heat.T
    dt = 3600.0
    for k in range(1, 4):
        T, iters, _ = heat.step(T, T, k * dt, dt)
        ref.step(k * dt, dt)
        want = ref.T.numpy()
        assert int(iters) > 0
        assert np.abs(T.numpy() - want[node]).max() <= 1e-10 * np.abs(
            want).max()
        assert np.ptp(want) > 0.1        # the wall and the top moved T


# each fault is applied once the set-up is done, so that the timed path
# (the episodes) runs broken underneath an intact harness
FAULTS = {
    # a coupled step that returns its state unchanged
    "state_unchanged": """
from safeincave_torch.fem.momentum import LinearMomentum
import numpy as np
def steps(self, heat, ts, dts, tol=1e-6, maxiter=20):
    return np.array([[20, 0.0, 3, 0.0, 10, 1.0]] * len(ts))
def step(self, t, dt, tol=1e-6, maxiter=20):
    return 3, 0.0
LinearMomentum.solve_tm_time_steps = steps
LinearMomentum.solve_time_step = step
""",
    # a heat step that returns T unchanged
    "heat_unchanged": """
from safeincave_torch.fem.heat import HeatDiffusion
real = HeatDiffusion.step
def step(self, T, T_old, t, dt):
    _, iters, res = real(self, T, T_old, t, dt)
    return T, iters, res
HeatDiffusion.step = step
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


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_coupled_path_is_not_correct(fault):
    """The harness runs whole, with the coupled path broken underneath
    after set-up, and ``correct`` comes out false."""
    prelude = (
        "import episodes\n"
        "_setup = episodes.Cell.setup\n"
        "def setup(self):\n"
        "    _setup(self)\n"
        f"    exec({FAULTS[fault]!r}, {{}})\n"
        "episodes.Cell.setup = setup\n")
    rc, result, err = rehearse(TM, prelude=prelude)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]


def test_a_coupled_cell_refuses_checkpoints_and_step_metrics():
    """``Simulator_TM`` takes neither: the run fails and says why."""
    prelude = (
        "import episodes\n"
        "_init = episodes.Cell.__init__\n"
        "def init(self, *a, **kw):\n"
        "    _init(self, *a, **kw)\n"
        "    self.traffic = dict(self.traffic, checkpoint_every=12)\n"
        "episodes.Cell.__init__ = init\n")
    rc, result, err = rehearse(TM, prelude=prelude)
    assert rc != 0 and result is None
    assert "Simulator_TM takes no checkpoint cadence" in err


# the recorder's counts as they were before it learned the coupled calls
OLD_COUNTS = """
import sys
import episodes

def old_counts(calls):
    steps = fp = kry = 0
    sig = []
    for c in calls:
        if c[0] == "fused":
            rows = c[1]
            steps += int((rows[:, 5] > 0.5).sum())
            fp += int(rows[:, 0].sum())
            kry += int(rows[:, 2].sum())
            sig.append(("fused", rows[:, [0, 2, 5]].tolist()))
        elif c[0] == "step":
            fp += int(c[1])
            kry += int(c[3])
            sig.append(("step", int(c[1]), int(c[3])))
        else:
            steps += 1
    return steps, fp, kry, sig

_counts = episodes.counts
def counts(calls):
    new = _counts(calls)
    same = (new["steps"], new["fp"], new["krylov"], new["work"]) \\
        == old_counts(calls) and new["heat_cg"] is None
    print("counts", len(calls), int(same), file=sys.stderr)
    return new
episodes.counts = counts
"""


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      manifest()["workloads"]
                                      if w["name"] not in coupled_cells()])
def test_momentum_cells_count_as_before(workload):
    """Every episode of a momentum cell (the one before the window and the
    window's) gives the counts and work signature that the recorder gave
    before it learned ``solve_tm_time_steps`` and the heat calls, and no
    heat count."""
    rc, result, err = rehearse(workload, prelude=OLD_COUNTS)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    found = [line.split()[1:] for line in err.splitlines()
             if line.startswith("counts ")]
    assert len(found) >= 2
    assert all(int(n) > 0 and same == "1" for n, same in found), found
