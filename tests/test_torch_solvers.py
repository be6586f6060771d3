"""PyTorch port vs JAX package: CG, BiCGStab and the mixed-precision
``ir_solve`` on one shared operator.

The operator is the masked elastic stiffness of a band-reordered box (each
package's own matrix-free matvec on identical geometry), the preconditioner
the same nodal block-Jacobi inverse for both.  The f64 solvers must take the
same number of iterations and reach the same residual to 1e-10 of ||b||.

Each package sums its matvec and dot products in its own order, and a
Krylov recurrence amplifies those last-bit differences geometrically: on
this operator the two CG residual histories agree to ~1e-12 up to
iteration 40 and differ by 10% at iteration 70 (BiCGStab separates
faster).  The f64 checks therefore stop at rtol 1e-4, where the histories
still agree to ~1e-12 (CG) and ~1e-8 (BiCGStab), far inside the margin that
decides the iteration count.

For ``ir_solve`` the f32 inner operator sums in another order in each
package, so its inner counts may differ: both must reach the f64 target, the
inner counts must agree within 10% and the solutions to 1e-10 max|x|.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from safeincave_tpu.fem import solvers as jsol
from safeincave_tpu.fem.kernels import MomentumKernel as JaxKernel
from safeincave_tpu.fem.momentum import _blk_apply as jax_blk_apply
from safeincave_tpu.mesh.boxgen import GridBox as JaxGridBox
from safeincave_tpu.mesh.reorder import reordered_grid as jax_reordered
from safeincave_torch.fem import solvers as psol
from safeincave_torch.fem.kernels import MomentumKernel
from safeincave_torch.fem.momentum import _blk_apply
from safeincave_torch.linalg import inv3x3
from safeincave_torch.materials.elastic import isotropic_C
from safeincave_torch.mesh.boxgen import GridBox
from safeincave_torch.mesh.reorder import reordered_grid

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    dims = dict(Lx=600.0, Ly=600.0, Lz=800.0, nx=4, ny=4, nz=4)
    g_port = reordered_grid(GridBox(**dims), method="band")[0]
    g_jax = jax_reordered(JaxGridBox(**dims), method="band")[0]
    E, N = g_port.n_elems, g_port.n_nodes
    C = isotropic_C(102e9 * np.ones(E), 0.3 * np.ones(E))
    mask = np.ones((N, 3))
    for name, comp in (("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2)):
        nodes = np.unique(g_port.tris[g_port.get_boundary_tags(name)])
        mask[nodes, comp] = 0.0
    kern = MomentumKernel(g_port, "cpu")
    blk = kern.block_diagonal(C) * mask[:, :, None] * mask[:, None, :]
    blk = blk + (1.0 - mask)[:, :, None] * np.eye(3)[None]
    blk_inv = inv3x3(torch.as_tensor(blk)).numpy()
    rng = np.random.default_rng(0)
    b = rng.normal(size=(N, 3)) * 1e6 * mask
    return dict(port=(kern, g_port), jax=(JaxKernel(g_jax), g_jax), C=C,
                mask=mask, blk_inv=blk_inv, b=b)


def _ops(p, pkg):
    """(A_hi, A_lo, M_inv, to_array) of one package."""
    if pkg == "port":
        kern, _ = p["port"]
        arr = torch.as_tensor
        C64 = kern.prep(arr(p["C"]))
        C32 = kern.prep(arr(p["C"]).float())
        m64, inv = arr(p["mask"]), arr(p["blk_inv"])
        blk = _blk_apply
    else:
        kern, _ = p["jax"]
        arr = jnp.asarray
        C64 = kern.prep(arr(p["C"]))
        C32 = kern.prep(arr(p["C"]).astype(jnp.float32))
        m64, inv = arr(p["mask"]), arr(p["blk_inv"])
        blk = jax_blk_apply
    m32 = m64.astype(jnp.float32) if pkg == "jax" else m64.float()

    def A_hi(x):
        return m64 * kern.matvec(C64, m64 * x) + (1.0 - m64) * x

    def A_lo(x):
        return m32 * kern.matvec(C32, m32 * x) + (1.0 - m32) * x

    def M_inv(r):
        return blk(inv, r)

    return A_hi, A_lo, M_inv, arr


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_f64_krylov_counts_and_residuals_match(problem, method):
    out = {}
    for pkg, mod in (("port", psol), ("jax", jsol)):
        A_hi, _, M_inv, arr = _ops(problem, pkg)
        b = arr(problem["b"])
        solve = getattr(mod, f"{method}_solve")
        x, k, res = solve(A_hi, b, b * 0.0, M_inv, rtol=1e-4, maxiter=500)
        out[pkg] = (np.asarray(x), int(k), float(res))
    (xp, kp, rp), (xj, kj, rj) = out["port"], out["jax"]
    assert kp == kj and 0 < kp < 500
    bn = np.linalg.norm(problem["b"])
    assert abs(rp - rj) <= 1e-10 * bn
    np.testing.assert_allclose(xp, xj, rtol=0, atol=1e-8 * np.abs(xj).max())


def test_ir_solve_matches(problem):
    out = {}
    for pkg, mod in (("port", psol), ("jax", jsol)):
        A_hi, A_lo, M_inv, arr = _ops(problem, pkg)
        b = arr(problem["b"])
        x, k, res = mod.ir_solve(A_hi, A_lo, b, b * 0.0, M_inv,
                                 inner_solve=mod.bicgstab_solve, rtol=1e-12,
                                 inner_rtol=1e-4, inner_maxiter=400,
                                 max_passes=12)
        out[pkg] = (np.asarray(x), int(k), float(res))
    (xp, kp, rp), (xj, kj, rj) = out["port"], out["jax"]
    bn = np.linalg.norm(problem["b"])
    assert rp <= 1e-12 * bn and rj <= 1e-12 * bn
    assert abs(kp - kj) <= 0.1 * kj
    np.testing.assert_allclose(xp, xj, rtol=0, atol=1e-10 * np.abs(xj).max())
