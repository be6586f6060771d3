"""PyTorch port vs JAX package: the heat equation.

The same seeded numpy inputs go through both packages, every port object on
``device="cpu"``:

- ``HeatKernel``'s mass and stiffness actions, their diagonals and the
  node-to-element average on an irregular (jittered) box mesh: 1e-12 of
  max|ref| in float64, 2e-5 in float32 (both packages sum the at most K
  corner contributions of a node, in different orders);
- every array of the heat boundary conditions (Dirichlet mask and values,
  Neumann and Robin right-hand sides, the Robin operator and its diagonal)
  at two times, 1e-12;
- ``HeatDiffusion.solve`` and ``solve_steps`` over 5 steps with ramping
  Dirichlet, Neumann and Robin conditions, mixed precision and float64: the
  temperature at 1e-9 of max|ref| (CG iteration counts may differ: the
  float32 sums run in another order);
- ``Simulator_T`` in the per-step flow and in fused chunks: the ``T`` outputs
  of both packages, read back, at 1e-9, with equal save times.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_tpu import postproc
from safeincave_tpu.fem.kernels import HeatKernel as JaxHeatKernel
from safeincave_torch.fem.kernels import HeatKernel, NodeGather

torch.set_num_threads(1)

HOUR = cfg.HOUR


def _grids():
    """The same irregular box in both packages: a 3x3x3 box whose interior
    nodes are moved by a seeded jitter."""
    rng = np.random.default_rng(5)
    out = []
    for pkg in (sc, st):
        box = pkg.GridBox(Lx=3.0, Ly=2.0, Lz=4.0, nx=3, ny=3, nz=3)
        pts = np.array(box.points)
        inner = np.all((pts > 1e-9) & (pts < np.array([3., 2., 4.]) - 1e-9),
                       axis=1)
        if not out:
            jitter = 0.15 * rng.uniform(-1, 1, size=pts.shape) * inner[:, None]
        names = {n: (t, 2) for n, t in box.dolfin_tags[2].items()}
        names.update({n: (t, 3) for n, t in box.dolfin_tags[3].items()})
        out.append(pkg.Grid(pts + jitter, box.conn, box.elem_tags, box.tris,
                            box.tri_tags, names))
    return out


@pytest.fixture(scope="module")
def grids():
    gj, gp = _grids()
    np.testing.assert_array_equal(gp.grad_N, np.asarray(gj.grad_N))
    return gj, gp


def _close(got, want, rtol, what):
    got, want = cfg.as_np(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= rtol * scale, \
        (what, np.abs(got - want).max() / scale)


# --------------------------------------------------------------------------- #
# HeatKernel
# --------------------------------------------------------------------------- #
PIECES = {
    "mass_apply": lambda k, coef, cond, T: k.mass_apply(coef, T),
    "stiffness_apply": lambda k, coef, cond, T: k.stiffness_apply(cond, T),
    "mass_diagonal": lambda k, coef, cond, T: k.mass_diagonal(coef),
    "stiffness_diagonal": lambda k, coef, cond, T: k.stiffness_diagonal(cond),
    "nodes_to_elems": lambda k, coef, cond, T: k.nodes_to_elems(T),
}


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("piece", sorted(PIECES))
def test_heat_kernel_piece(grids, piece, dtype):
    gj, gp = grids
    rng = np.random.default_rng(1)
    coef = 2200.0 * 850.0 / HOUR * rng.uniform(0.5, 2.0, gj.n_elems)
    cond = 7.0 * rng.uniform(0.5, 2.0, gj.n_elems)
    T = 298.0 + 20.0 * rng.normal(size=gj.n_nodes)
    jt, tt = (jnp.float64, torch.float64) if dtype == "f64" else \
        (jnp.float32, torch.float32)
    want = PIECES[piece](JaxHeatKernel(gj), jnp.asarray(coef, jt),
                         jnp.asarray(cond, jt), jnp.asarray(T, jt))
    got = PIECES[piece](HeatKernel(gp, "cpu"), torch.as_tensor(coef, dtype=tt),
                        torch.as_tensor(cond, dtype=tt),
                        torch.as_tensor(T, dtype=tt))
    assert got.dtype == tt
    _close(got, want, 1e-12 if dtype == "f64" else 2e-5, piece)


def test_heat_operator_takes_f64_coefficients_in_f32(grids):
    """The float32 operator is given float64 rho cp / dt and k, as the
    solver holds them, and stays float32."""
    _, gp = grids
    k = HeatKernel(gp, "cpu")
    coef = torch.full((gp.n_elems,), 500.0, dtype=torch.float64)
    T = torch.linspace(290, 300, gp.n_nodes, dtype=torch.float32)
    assert k.mass_apply(coef, T).dtype == torch.float32
    assert k.stiffness_apply(coef, T).dtype == torch.float32


def test_node_gather_sums_like_index_add_and_repeats():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 50, size=400)
    keys[keys == 7] = 8                    # an empty bin
    vals = torch.as_tensor(rng.normal(size=400))
    g = NodeGather.build(keys, 50, "cpu")
    want = torch.zeros(50, dtype=torch.float64).index_add_(
        0, torch.as_tensor(keys), vals)
    got = g.sum(vals)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-14)
    assert got[7] == 0.0 and torch.equal(got, g.sum(vals))
    assert g.idx.shape == (50, int(np.bincount(keys).max()))


# --------------------------------------------------------------------------- #
# boundary conditions
# --------------------------------------------------------------------------- #
def _heat(pkg, grid, precision="mixed"):
    """A heat equation with ramping Dirichlet (TOP), Neumann (EAST) and two
    Robin (BOTTOM, WEST) conditions and per-element properties."""
    rng = np.random.default_rng(3)
    n = grid.n_elems
    mat = pkg.Material(n, **cfg.on(pkg, "cpu"))
    mat.set_density(2200.0 * rng.uniform(0.9, 1.1, n))
    mat.set_specific_heat_capacity(850.0 * rng.uniform(0.9, 1.1, n))
    mat.set_thermal_conductivity(7.0 * rng.uniform(0.5, 2.0, n))
    heat = pkg.HeatDiffusion(grid, **cfg.on(pkg, "cpu"))
    heat.set_solver(pkg.SolverSettings(method="cg", rtol=1e-12, max_it=400,
                                       precision=precision))
    heat.set_material(mat)
    heat.set_initial_T(298.0 + rng.normal(size=grid.n_nodes))
    hb = pkg.HeatBC
    bc = hb.BcHandler(heat)
    tv = [0.0, 2 * HOUR, 10 * HOUR]
    bc.add_boundary_condition(hb.DirichletBC("TOP", [298., 310., 305.], tv))
    bc.add_boundary_condition(hb.NeumannBC("EAST", [0., 40., 10.], tv))
    bc.add_boundary_condition(hb.RobinBC("BOTTOM", [298., 280., 280.], 25.0,
                                         tv))
    bc.add_boundary_condition(hb.RobinBC("WEST", [300., 300., 320.], 5.0, tv))
    heat.set_boundary_conditions(bc)
    return heat


BC_ARRAYS = {
    "dirichlet_mask": lambda bc, t, T: bc.dirichlet_arrays(t)[0],
    "dirichlet_values": lambda bc, t, T: bc.dirichlet_arrays(t)[1],
    "neumann_rhs": lambda bc, t, T: bc.neumann_rhs(t),
    "robin_rhs": lambda bc, t, T: bc.robin_rhs(t),
    "robin_operator_apply": lambda bc, t, T: bc.robin_operator_apply(T),
    "robin_diagonal": lambda bc, t, T: bc.robin_diagonal(),
}


@pytest.mark.parametrize("t", [0.7 * HOUR, 5.5 * HOUR])
@pytest.mark.parametrize("name", sorted(BC_ARRAYS))
def test_heat_bc_array(grids, name, t):
    gj, gp = grids
    T = 298.0 + np.random.default_rng(4).normal(size=gj.n_nodes)
    want = BC_ARRAYS[name](_heat(sc, gj).bc, t, jnp.asarray(T))
    got = BC_ARRAYS[name](_heat(st, gp).bc, t, torch.as_tensor(T))
    assert np.abs(np.asarray(want)).max() > 0
    _close(got, want, 1e-12, name)


def test_heat_bc_update_api_and_reset(grids):
    gj, gp = grids
    bj, bp = _heat(sc, gj).bc, _heat(st, gp).bc
    bj.update_bcs(3 * HOUR)
    bp.update_bcs(3 * HOUR)
    for attr in ("mask", "T_bc", "b_neumann", "b_robin"):
        _close(getattr(bp, attr), getattr(bj, attr), 1e-12, attr)
    assert len(bp.robin_boundaries) == 2 and len(bp.neumann_boundaries) == 1
    bp.reset_boundary_conditions()
    assert not (bp.dirichlet_boundaries or bp._robin_meta)
    assert float(bp.robin_diagonal().abs().max()) == 0.0
    with pytest.raises(ValueError, match="not supported"):
        bad = st.HeatBC.GeneralBC("TOP", [0.], [0.])
        bad.type = "periodic"
        bp.add_boundary_condition(bad)


# --------------------------------------------------------------------------- #
# HeatDiffusion
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["solve", "solve_steps"])
@pytest.mark.parametrize("precision", ["mixed", "f64"])
def test_heat_steps_match_jax(grids, precision, mode):
    gj, gp = grids
    hj, hp = _heat(sc, gj, precision), _heat(st, gp, precision)
    ts = [(k + 1) * HOUR for k in range(5)]
    dts = [HOUR] * 5
    if mode == "solve":
        for t, dt in zip(ts, dts):
            hj.solve(t, dt)
            hp.solve(t, dt)
            _close(hp.T, hj.T, 1e-9, f"T at {t}")
    else:
        rj, rp = hj.solve_steps(ts, dts), hp.solve_steps(ts, dts)
        assert rp.shape == np.asarray(rj).shape == (5, 2)
        assert (rp[:, 0] > 0).all()
        assert hp.solver_stats == (int(rp[-1, 0]), float(rp[-1, 1]))
    _close(hp.T, hj.T, 1e-9, "T")
    _close(hp.T_old, hj.T_old, 1e-9, "T_old")
    _close(hp.get_T_elems(), hj.get_T_elems(), 1e-9, "T_elems")
    # converged: the residual is below rtol ||b||, far below the field
    assert hp.solver_stats[1] < 1e-6
    assert np.ptp(cfg.as_np(hp.T)) > 5.0


def test_heat_step_returns_new_tensors(grids):
    """A step replaces T and T_old and never writes into them: a snapshot
    that shares the tensors (the dt-retry's) keeps its values."""
    _, gp = grids
    heat = _heat(st, gp)
    T0, T0_copy = heat.T, heat.T.clone()
    x, iters, res = heat.step(heat.T, heat.T_old, HOUR, HOUR)
    assert heat.T is T0 and torch.equal(T0, T0_copy)
    heat.solve(HOUR, HOUR)
    assert torch.equal(T0, T0_copy) and torch.equal(heat.T, x)
    assert heat.T is heat.T_old and heat.T is not T0


def test_initial_T_scalar_and_field(grids):
    _, gp = grids
    heat = st.HeatDiffusion(gp, device="cpu")
    heat.set_initial_T(298.0)
    assert heat.T.shape == (gp.n_nodes,) and heat.T.dtype == torch.float64
    assert float(heat.T.min()) == float(heat.T.max()) == 298.0
    heat.set_initial_T(np.arange(gp.n_nodes, dtype=float))
    assert torch.equal(heat.T_old, heat.T)
    np.testing.assert_allclose(heat.get_T_elems().numpy(),
                               np.arange(gp.n_nodes)[gp.conn].mean(1))


# --------------------------------------------------------------------------- #
# Simulator_T
# --------------------------------------------------------------------------- #
def _run_T(pkg, grid, folder, save_every, fused):
    heat = _heat(pkg, grid)
    out = pkg.SaveFields(heat, save_every=save_every)
    out.set_output_folder(folder)
    out.add_output_field("T", "Temperature (K)")
    tc = pkg.TimeController(dt=1.0, initial_time=0.0, final_time=6.0,
                            time_unit="hour")
    sim = pkg.Simulator_T(heat, tc, [out], fused_steps=fused)
    sim.run()
    return sim, heat


@pytest.mark.parametrize("flow", ["per_step", "fused"])
def test_simulator_T_outputs_match_jax(grids, tmp_path, flow):
    gj, gp = grids
    every, fused = (1, 1) if flow == "per_step" else (3, "auto")
    _, hj = _run_T(sc, gj, str(tmp_path / "jax"), every, fused)
    sim, hp = _run_T(st, gp, str(tmp_path / "port"), every, fused)
    t_ref, ref, _, _ = postproc.read_timeseries(str(tmp_path / "jax"), "T")
    t, got, _, _ = postproc.read_timeseries(str(tmp_path / "port"), "T")
    np.testing.assert_array_equal(t, t_ref)
    np.testing.assert_array_equal(t, HOUR * np.arange(0, 7, every))
    for k in range(ref.shape[0]):
        _close(got[k], ref[k], 1e-9, f"T save {k}")
    _close(hp.T, hj.T, 1e-9, "final T")
    rows = cfg.screen_rows(sim.screen.lines)
    assert len(rows) == 6
    # the fused flow reports each step's CG count, the per-step flow zeros
    assert (rows[:, 0] > 0).all() == (flow == "fused")


def test_simulator_T_fused_equals_per_step(grids, tmp_path):
    _, gp = grids
    _, a = _run_T(st, gp, str(tmp_path / "a"), 6, 1)
    _, b = _run_T(st, gp, str(tmp_path / "b"), 6, "auto")
    assert torch.equal(a.T, b.T)
