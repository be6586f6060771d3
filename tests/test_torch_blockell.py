"""PyTorch port vs JAX package: the assembled block-ELL operator.

Plan tables equal as integers; assembled blocks and the matvec within 1e-12
in f64 and 2e-5 max|ref| in f32 (the f32 stiffness-action bound of
tests/test_bandkernel.py); the 4 GiB refusal; the solver with block-ELL on
against the JAX package with block-ELL on, and against the port's own
cumsum operator.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_tpu.fem.blockell import BlockELL as JaxBlockELL
from safeincave_tpu.fem.blockell import BlockELLPlan as JaxPlan
from safeincave_tpu.fem.kernels import MomentumKernel as JaxKernel
from safeincave_tpu.mesh.reorder import reordered_grid as jax_reordered
from safeincave_torch.fem.blockell import BlockELL, BlockELLPlan
from safeincave_torch.fem.kernels import MomentumKernel
from safeincave_torch.mesh.reorder import reordered_grid

torch.set_num_threads(1)

DT = cfg.HOUR


def _grids(order, nx=4):
    out = []
    for pkg, reorder in ((sc, jax_reordered), (st, reordered_grid)):
        g = pkg.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=nx, ny=nx, nz=nx)
        out.append(g if order == "natural" else reorder(g, method=order)[0])
    return out


def _tangent(n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 6, 6))
    return 1e9 * (A @ A.transpose(0, 2, 1) + 6 * np.eye(6))


@pytest.mark.parametrize("order", ["natural", "band", "morton"])
@pytest.mark.parametrize("G", [4, 8])
def test_plan_tables_equal(order, G):
    gj, gp = _grids(order)
    pj = JaxPlan(np.asarray(gj.conn), gj.n_nodes, G=G)
    pp = BlockELLPlan(np.asarray(gp.conn), gp.n_nodes, G=G)
    assert (pp.Gn, pp.K, pp.n_slots, pp.n_pairs) == \
        (pj.Gn, pj.K, pj.n_slots, pj.n_pairs)
    np.testing.assert_array_equal(pp.nbr, pj.nbr)
    np.testing.assert_array_equal(pp.row_slot, pj.row_slot)
    assert pp.nbytes(4) == pj.nbytes(4)


@pytest.mark.parametrize("order", ["natural", "band"])
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 2e-5)])
def test_assemble_and_matvec(order, dtype, tol):
    gj, gp = _grids(order)
    CT = np.transpose(_tangent(gj.n_elems), (1, 2, 0)).astype(dtype)
    u = np.random.default_rng(2).normal(size=(gj.n_nodes, 3)).astype(dtype)
    bj = JaxBlockELL(JaxKernel(gj))
    kp = MomentumKernel(gp, "cpu")
    bp = BlockELL(kp)
    blocks_j = np.asarray(bj.assemble(jnp.asarray(CT)))
    blocks_p = bp.assemble(torch.as_tensor(CT))
    assert blocks_p.dtype == getattr(torch, dtype)
    assert tuple(blocks_p.shape) == blocks_j.shape
    np.testing.assert_allclose(blocks_p.numpy(), blocks_j, rtol=0,
                               atol=tol * np.abs(blocks_j).max())
    y_j = np.asarray(bj.matvec(jnp.asarray(blocks_j), jnp.asarray(u)))
    y_p = bp.matvec(blocks_p, torch.as_tensor(u))
    np.testing.assert_allclose(y_p.numpy(), y_j, rtol=0,
                               atol=tol * np.abs(y_j).max())
    # and it is the matrix-free operator
    y_mf = kp.matvec(torch.as_tensor(CT), torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(y_p.numpy(), y_mf, rtol=0,
                               atol=max(tol, 1e-11) * np.abs(y_mf).max())
    # deterministic: a second assembly is the same bits
    assert torch.equal(bp.assemble(torch.as_tensor(CT)), blocks_p)
    assert torch.equal(bp.operator(blocks_p)(torch.as_tensor(u)), y_p)


def test_refuses_a_plan_over_4_gib():
    """A numbering without locality inflates K: 200,000 tetrahedra drawn at
    random over 40,000 nodes couple every group of 8 nodes to hundreds of
    others."""
    from types import SimpleNamespace
    rng = np.random.default_rng(0)
    N, E = 40_000, 200_000
    conn = rng.integers(0, N, size=(E, 4)).astype(np.int32)
    grid = SimpleNamespace(n_nodes=N, n_elems=E, conn=conn,
                           grad_N=np.zeros((E, 4, 3)), volumes=np.ones(E))
    kern = MomentumKernel(grid, "cpu")
    with pytest.raises(ValueError, match="block-ELL plan needs .* GiB"):
        kern.enable_blockell()
    assert kern.blockell is None
    assert BlockELLPlan(conn, N).nbytes(8) > 4 << 30


def test_solver_with_blockell_on():
    """Block-ELL on in both packages: equal fixed-point counts, fields at
    1e-8; and the port's fields are its cumsum operator's at 1e-8."""
    gj, gp = _grids("band")
    runs = {}
    for key, pkg, grid, bell in (("jax", sc, gj, True), ("port", st, gp, True),
                                 ("cumsum", st, gp, False)):
        eq = cfg.wire_bench(pkg, grid, device="cpu")
        if bell:
            eq.enable_blockell_matvec()
            assert eq.kernel.blockell is not None
        cfg.elastic_init(eq)
        rows = np.asarray(eq.solve_time_steps([DT, 2 * DT], [DT, DT],
                                              tol=1e-8, maxiter=40))
        assert (rows[:, 5] == 1).all()
        runs[key] = (rows, {k: cfg.as_np(getattr(eq, k))
                            for k in ("u", "sig_v")})
    np.testing.assert_array_equal(runs["port"][0][:, 0], runs["jax"][0][:, 0])
    np.testing.assert_array_equal(runs["port"][0][:, 0],
                                  runs["cumsum"][0][:, 0])
    for other in ("jax", "cumsum"):
        for k, want in runs[other][1].items():
            np.testing.assert_allclose(runs["port"][1][k], want, rtol=1e-8,
                                       atol=1e-8 * np.abs(want).max(),
                                       err_msg=f"{other}: {k}")
