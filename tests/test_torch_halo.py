"""PyTorch port vs JAX package: the owned-node halo decomposition.

The port stacks the D parts on a leading axis of tensors on one device
(``make_device_mesh(D, device="cpu")`` here); the JAX package runs them on D
of the 8 virtual CPU devices of tests/conftest.py.  The same numpy inputs go
through both:

- ``HaloPlan``: every table equal element for element (GridBox nx=6 over 2,
  4 and 8 parts, the band-ordered cavern_proxy_600 over 8);
- ``matvec_padded`` and ``block_diagonal_padded`` in f64 at 1e-12 relative,
  the f32 ``matvec_pad`` at 2e-5 max|ref| of the JAX package's f64 action
  (tests/test_halo.py's inputs, GridBox nx=6 over 4 parts);
- ``halo_block_jacobi`` at 1e-12 and ``halo_two_level`` at 1e-5 (its coarse
  inverse is f32 in both packages);
- ``shard_equation(mode="halo")`` on tests/test_sharding.py's cube over 2
  steps against the JAX package's sharded run and the port's unsharded run
  (u 1e-8 relative, sig_v 1e-8 with 0.1 Pa), and with ``fp32_phase=True``,
  the f32 sweep's solve on the part layout, against JAX with the same flag.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_tpu.parallel import halo as jhalo
from safeincave_tpu.parallel import make_device_mesh as jax_mesh
from safeincave_tpu.parallel import shard_equation as jax_shard
from safeincave_torch.parallel import halo as thalo
from safeincave_torch.parallel import make_device_mesh, shard_equation

torch.set_num_threads(1)

PLAN_ARRAYS = ("elem_part", "owner", "node_perm", "send_idx", "conn_local",
               "elem_pad", "elem_gids", "grad_N_local", "vol_local",
               "recv_rows_true", "sent_rows_true", "recv_rows_padded")
PLAN_SIZES = ("S", "H", "B", "E_loc", "R", "n_nodes", "D", "round_sizes")


def _box(pkg, nx=6):
    return pkg.GridBox(nx=nx, ny=nx, nz=nx)


@pytest.mark.parametrize("mesh,D", [("box6", 2), ("box6", 4), ("box6", 8),
                                    ("cavern600", 8)])
def test_plan_tables_equal(mesh, D):
    grids = [_box(pkg) if mesh == "box6" else cfg.cavern600_grid(pkg)
             for pkg in (sc, st)]
    ref, got = jhalo.HaloPlan(grids[0], D), thalo.HaloPlan(grids[1], D)
    for k in PLAN_ARRAYS:
        a, b = np.asarray(getattr(ref, k)), np.asarray(getattr(got, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in PLAN_SIZES:
        assert getattr(ref, k) == getattr(got, k), k
    for r in range(ref.R):
        assert np.array_equal(ref.pair_send[r], got.pair_send[r])
        assert np.array_equal(ref.pair_recv[r], got.pair_recv[r])
        assert ref.perms[r] == got.perms[r]
    assert got.comm_volume_per_matvec() == ref.comm_volume_per_matvec()
    assert got.comm_rows_true() == ref.comm_rows_true()
    assert got.interface_fraction() == ref.interface_fraction()
    if mesh == "cavern600":   # chip_smoke.py's halo phase checks these
        assert (got.S, got.H, got.R) == (507, 163, 6)
        assert got.comm_volume_per_matvec() == 196


@pytest.fixture(scope="module")
def solvers():
    """Both packages' halo solvers on GridBox nx=6 over 4 parts, with
    tests/test_halo.py's random SPD tangents, vector and mask."""
    grid = _box(sc)
    rng = np.random.default_rng(0)
    E, N = grid.n_elems, grid.n_nodes
    A = rng.normal(size=(E, 6, 6))
    CT = A @ np.transpose(A, (0, 2, 1)) + 6 * np.eye(6)
    u = rng.normal(size=(N, 3))
    mask = (rng.random((N, 3)) > 0.1).astype(float)
    ref = jhalo.HaloMomentumSolver(grid, jax_mesh(4))
    got = thalo.HaloMomentumSolver(_box(st), make_device_mesh(4,
                                                              device="cpu"))
    return ref, got, CT, u, mask


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / \
        np.abs(np.asarray(ref)).max()


def test_matvec_and_block_diagonal(solvers):
    ref, got, CT, u, mask = solvers
    J, T = jnp.asarray, torch.as_tensor
    y_ref = ref.from_padded(ref.matvec_padded(
        ref.ct_to_local(J(CT)), ref.to_padded(J(u)), ref.to_padded(J(mask))))
    CT_l = got.ct_to_local(T(CT))
    y = got.from_padded(got.matvec_padded(CT_l, got.to_padded(T(u)),
                                          got.to_padded(T(mask))))
    assert _rel(y, y_ref) <= 1e-12
    # the unsharded port operator agrees too
    kern = st.fem.MomentumKernel(got.grid, "cpu")
    y_one = T(mask) * kern.matvec(kern.prep(T(CT)), T(mask) * T(u))
    assert _rel(y, y_one) <= 1e-12

    blk_ref = ref.block_diagonal_padded(ref.ct_to_local(J(CT)))
    assert _rel(got.block_diagonal_padded(CT_l), blk_ref) <= 1e-12

    # the f32 action on the f32 geometry twins, against the f64 reference
    y32 = got.matvec_pad(got.ct_to_local(T(CT).float()),
                         got.to_padded(T(u).float()),
                         got.to_padded(T(mask).float()))
    assert y32.dtype == torch.float32
    assert _rel(got.from_padded(y32), y_ref) <= 2e-5


@pytest.mark.parametrize("name,tol", [("halo_block_jacobi", 1e-12),
                                      ("halo_two_level", 1e-5)])
def test_preconditioner_apply(solvers, name, tol):
    ref, got, CT, u, mask = solvers
    rng = np.random.default_rng(1)
    r = rng.normal(size=(got.plan.D * got.S, 3))
    P_ref, apply_ref = getattr(jhalo, name)(ref, jnp.asarray(CT),
                                            jnp.asarray(mask))
    P, apply = getattr(thalo, name)(got, torch.as_tensor(CT),
                                    torch.as_tensor(mask))
    mp_ref = ref.to_padded(jnp.asarray(mask))
    mp = got.to_padded(torch.as_tensor(mask))
    z_ref = apply_ref(P_ref, jnp.asarray(r) * mp_ref, mp_ref)
    assert _rel(apply(P, torch.as_tensor(r) * mp, mp), z_ref) <= tol


def _sharded_run(pkg, D, fp32_phase):
    eq = cfg.sharding_box(pkg, device="cpu", fp32_phase=fp32_phase)
    n_true = eq.n_elems
    if pkg is st:
        shard_equation(eq, make_device_mesh(D, device="cpu"), mode="halo")
    else:
        jax_shard(eq, jax_mesh(D), mode="halo")
    assert eq._halo is not None and eq.n_elems % D == 0
    u, sig, rows = cfg.run_sharding_steps(eq)
    return eq, u, sig[:n_true], rows


@pytest.mark.parametrize("D,fp32_phase", [(8, False), (4, True)])
def test_shard_equation_halo(D, fp32_phase):
    eq, u, sig, rows = _sharded_run(st, D, fp32_phase)
    assert eq.n_elems > eq.n_elems_orig        # padded cells exercised
    assert eq.kernel.band is None and eq.kernel.dia is None
    if fp32_phase:
        assert eq._solve32 is not None         # the sweep ran on the parts
    _, u_ref, sig_ref, rows_ref = _sharded_run(sc, D, fp32_phase)
    np.testing.assert_array_equal(rows[:, 0], rows_ref[:, 0])
    np.testing.assert_allclose(u, u_ref, rtol=1e-8, atol=1e-13)
    np.testing.assert_allclose(sig, sig_ref, rtol=1e-8, atol=0.1)

    one = cfg.sharding_box(st, device="cpu", fp32_phase=fp32_phase)
    u_one, sig_one, _ = cfg.run_sharding_steps(one)
    np.testing.assert_allclose(u, u_one, rtol=1e-8, atol=1e-13)
    np.testing.assert_allclose(sig, sig_one, rtol=1e-8, atol=0.1)
