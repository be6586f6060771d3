"""PyTorch port vs JAX package: element sharding with the summed (psum)
assembly, the coupled pair under ``shard_tm``, and the padded element
count at the edges of a sharded run (outputs, checkpoints, ``interop``).

The port runs D parts stacked on one device (``make_device_mesh(D,
device="cpu")``), the JAX package on D of tests/conftest.py's 8 virtual CPU
devices; the same numpy inputs go through both.  GridBox nx=3 has 162
elements, so 4 parts pad 2 cells and 8 parts pad 6.

- every method of ``ShardedMomentumKernel`` (``strain``,
  ``internal_force``, ``matvec``, ``diagonal``, ``block_diagonal``,
  ``body_force``) and of ``ShardedHeatKernel`` at 1e-12 of JAX's, and the
  padded cells inert (tests/test_sharding.py's twin);
- ``shard_equation(mode="psum")`` over 2 steps against JAX's psum run and
  the port's unsharded run (u 1e-8 relative, sig_v 1e-8 with 0.1 Pa);
- ``shard_tm`` on ``torch_port_configs.tm_cube`` against JAX's ``shard_tm``
  and the unsharded pair: T rtol 1e-10 / atol 1e-8, u 1e-8;
- a sharded ``Simulator_M`` run writes unpadded element fields, its
  checkpoint loads into an unsharded equation and an unsharded one into a
  sharded equation, ``interop.numpy_state`` reads the true element count;
- ``make_device_mesh`` defaults to the card and raises without one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_tpu.parallel import make_device_mesh as jax_mesh
from safeincave_tpu.parallel import shard_equation as jax_shard
from safeincave_tpu.parallel import shard_tm as jax_shard_tm
from safeincave_tpu.parallel import sharding as jsharding
from safeincave_torch import interop
from safeincave_torch.parallel import (ShardedHeatKernel,
                                       ShardedMomentumKernel,
                                       make_device_mesh, shard_equation,
                                       shard_tm)

torch.set_num_threads(1)

D = 4


def _mesh():
    return make_device_mesh(D, device="cpu")


def _close(got, ref, tol=1e-12):
    got, ref = cfg.as_np(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_momentum_kernel_methods_match_jax():
    grid_j, grid_t = sc.GridBox(nx=3, ny=3, nz=3), st.GridBox(nx=3, ny=3,
                                                               nz=3)
    ref = jsharding.ShardedMomentumKernel(grid_j, jax_mesh(D))
    got = ShardedMomentumKernel(grid_t, _mesh())
    assert (got.n_elems, got.n_pad, got.n_elems_orig) == \
        (ref.n_elems, ref.n_pad, 162)
    rng = np.random.default_rng(0)
    E, N = got.n_elems, grid_t.n_nodes
    A = rng.normal(size=(E, 6, 6))
    CT = A @ np.transpose(A, (0, 2, 1)) + 6 * np.eye(6)
    u = rng.normal(size=(N, 3))
    sv = rng.normal(size=(E, 6))
    rho = 2000.0 + rng.random(E)
    J, T = jnp.asarray, torch.as_tensor
    assert got.prep(T(CT)) is not None and got.prep(T(CT)).shape == (E, 6, 6)
    _close(got.strain(T(u)), ref.strain(J(u)))
    _close(got.internal_force(T(sv)), ref.internal_force(J(sv)))
    _close(got.matvec(T(CT), T(u)), ref.matvec(J(CT), J(u)))
    _close(got.diagonal(T(CT)), ref.diagonal(J(CT)))
    _close(got.block_diagonal(CT), ref.block_diagonal(J(CT)))
    _close(got.body_force(rho, [0.0, 0.0, -9.81]),
           ref.body_force(J(rho), [0.0, 0.0, -9.81]))
    _close(got.apply66(T(CT), T(sv)), ref.apply66(J(CT), J(sv)))
    # the f32 geometry twin serves f32 inputs
    assert got.matvec(T(CT).float(), T(u).float()).dtype == torch.float32
    # the host element stiffness (dense and two-level preconditioners) is
    # zero on the padded cells
    Ke = got.element_stiffness(CT)
    assert Ke.shape[0] == E and not Ke[162:].any()


def test_heat_kernel_methods_match_jax():
    grid_j, grid_t = sc.GridBox(nx=3, ny=3, nz=3), st.GridBox(nx=3, ny=3,
                                                               nz=3)
    ref = jsharding.ShardedHeatKernel(grid_j, jax_mesh(D))
    got = ShardedHeatKernel(grid_t, _mesh())
    rng = np.random.default_rng(2)
    E, N = got.n_elems, grid_t.n_nodes
    coef, k = 1.0 + rng.random(E), 5.0 + rng.random(E)
    T_n = 298.0 + rng.normal(size=N)
    J, T = jnp.asarray, torch.as_tensor
    _close(got.mass_apply(T(coef), T(T_n)), ref.mass_apply(J(coef), J(T_n)))
    _close(got.stiffness_apply(T(k), T(T_n)),
           ref.stiffness_apply(J(k), J(T_n)))
    _close(got.mass_diagonal(T(coef)), ref.mass_diagonal(J(coef)))
    _close(got.stiffness_diagonal(T(k)), ref.stiffness_diagonal(J(k)))
    _close(got.nodes_to_elems(T(T_n)), ref.nodes_to_elems(J(T_n)))


def test_padded_cells_are_inert():
    eq = cfg.sharding_box(st, nx=2, device="cpu")
    shard_equation(eq, make_device_mesh(5, device="cpu"))
    assert eq.n_elems == 50 and eq.n_elems_orig == 48
    f = eq.kernel.internal_force(torch.ones((eq.n_elems, 6),
                                            dtype=torch.float64))
    assert torch.isfinite(f).all()
    fz = float(eq.kernel.body_force(eq.mat.density,
                                    [0, 0, -9.81])[:, 2].sum())
    np.testing.assert_allclose(fz, -9.81 * 2000.0 * 1.0, rtol=1e-10)


def test_shard_equation_psum():
    eq = cfg.sharding_box(st, device="cpu")
    n = eq.n_elems
    shard_equation(eq, _mesh(), mode="psum")
    assert eq._halo is None and eq.n_elems % D == 0
    u, sig, rows = cfg.run_sharding_steps(eq)
    ref = cfg.sharding_box(sc)
    jax_shard(ref, jax_mesh(D), mode="psum")
    u_ref, sig_ref, rows_ref = cfg.run_sharding_steps(ref)
    np.testing.assert_array_equal(rows[:, 0], rows_ref[:, 0])
    one = cfg.sharding_box(st, device="cpu")
    u_one, sig_one, _ = cfg.run_sharding_steps(one)
    for u_x, sig_x in ((u_ref, sig_ref[:n]), (u_one, sig_one)):
        np.testing.assert_allclose(u, u_x, rtol=1e-8, atol=1e-13)
        np.testing.assert_allclose(sig[:n], sig_x, rtol=1e-8, atol=0.1)


def _tm_run(eq, heat, n_steps=2, dt=cfg.HOUR):
    cfg.tm_init(eq, heat)
    rows = eq.solve_tm_time_steps(heat, [(k + 1) * dt for k in range(n_steps)],
                                  [dt] * n_steps, tol=1e-6, maxiter=20)
    assert (np.asarray(rows)[:, 5] > 0.5).all(), rows
    return cfg.as_np(eq.u), cfg.as_np(eq.sig_v), cfg.as_np(heat.T)


def test_shard_tm():
    eq, heat = cfg.tm_cube(st, "cpu")
    n = eq.n_elems
    shard_tm(eq, heat, _mesh())
    assert eq._halo is not None and heat.kernel.n_elems == eq.n_elems
    assert heat.k.shape[0] == eq.n_elems
    u, sig, T_n = _tm_run(eq, heat)
    eq_j, heat_j = cfg.tm_cube(sc)
    jax_shard_tm(eq_j, heat_j, jax_mesh(D))
    u_ref, sig_ref, T_ref = _tm_run(eq_j, heat_j)
    eq_1, heat_1 = cfg.tm_cube(st, "cpu")
    u_one, sig_one, T_one = _tm_run(eq_1, heat_1)
    for u_x, sig_x, T_x in ((u_ref, sig_ref[:n], T_ref),
                            (u_one, sig_one, T_one)):
        np.testing.assert_allclose(T_n, T_x, rtol=1e-10, atol=1e-8)
        np.testing.assert_allclose(u, u_x, rtol=1e-8, atol=1e-13)
        np.testing.assert_allclose(sig[:n], sig_x, rtol=1e-8, atol=0.1)


def test_outputs_and_checkpoints_unpadded(tmp_path):
    from safeincave_torch import postproc
    eq = cfg.sharding_box(st, device="cpu")
    n_true = eq.n_elems
    shard_equation(eq, _mesh())
    assert eq.n_elems > n_true

    out = st.SaveFields(eq)
    folder = str(tmp_path / "out")
    out.set_output_folder(folder)
    out.add_output_field("u", "Displacement (m)")
    out.add_output_field("sig", "Stress (Pa)")
    out.add_output_field("q_elems", "Von Mises (Pa)")
    tc = st.TimeController(dt=1.0, initial_time=0.0, final_time=1.0,
                           time_unit="hour")
    st.Simulator_M(eq, tc, [out]).run()
    _, v, _, _ = postproc.read_timeseries(folder, "sig")
    assert v.shape[1] == n_true
    state = interop.numpy_state(eq)
    assert state["sig_v"].shape[0] == n_true
    assert all(a.shape[0] == n_true for a in state["states"][0].values())

    # sharded -> unsharded
    ckpt = str(tmp_path / "ck.npz")
    st.save_checkpoint(ckpt, eq, tc)
    with np.load(ckpt) as z:
        assert z["sig_v"].shape[0] == n_true
    eq2 = cfg.sharding_box(st, device="cpu")
    tc2 = st.TimeController(dt=1.0, initial_time=0.0, final_time=2.0,
                            time_unit="hour")
    st.load_checkpoint(ckpt, eq2, tc2)
    np.testing.assert_array_equal(cfg.as_np(eq2.sig_v),
                                  cfg.as_np(eq.sig_v)[:n_true])
    assert tc2.step_counter == tc.step_counter

    # unsharded -> sharded: padded again as shard_equation pads
    ckpt2 = str(tmp_path / "ck2.npz")
    st.save_checkpoint(ckpt2, eq2, tc2)
    eq3 = cfg.sharding_box(st, device="cpu")
    shard_equation(eq3, _mesh())
    st.load_checkpoint(ckpt2, eq3)
    for name in ("sig_v", "eps_tot_v", "Temp", "T0"):
        assert getattr(eq3, name).shape[0] == eq3.n_elems
        # the padded rows too: zero stress and strain, edge temperatures
        torch.testing.assert_close(getattr(eq3, name), getattr(eq, name),
                                   rtol=0, atol=0)
    for a, b in zip(eq3.mat.elems_ne, eq.mat.elems_ne):
        for k, v in a.state.items():
            torch.testing.assert_close(v[:n_true], b.state[k][:n_true],
                                       rtol=0, atol=0)
    # and it steps on from there like the straight sharded run
    rows3 = eq3.solve_time_steps([2 * cfg.HOUR], [cfg.HOUR])
    rows = eq.solve_time_steps([2 * cfg.HOUR], [cfg.HOUR])
    assert rows3[0, 5] == rows[0, 5] == 1
    np.testing.assert_allclose(cfg.as_np(eq3.u), cfg.as_np(eq.u),
                               rtol=1e-12, atol=1e-20)


def test_device_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        mesh = make_device_mesh()
        assert mesh.device.type == "cuda"
        assert mesh.n_parts == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_device_mesh(4)
    with pytest.raises(ValueError):
        make_device_mesh(device="cpu")
    eq = cfg.sharding_box(st, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        shard_equation(eq)
    mesh = make_device_mesh(2, device="cpu")
    assert (mesh.n_parts, mesh.device.type, mesh.axis) == (2, "cpu", "e")
