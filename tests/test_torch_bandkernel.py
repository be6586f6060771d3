"""PyTorch port vs JAX package: the f32 band stiffness action and the f64
matrix-free kernel pieces.

On the CPU the port's ``BandMatvec`` runs its plain twin
(``band_matvec_plain``); it is held against the Pallas band kernel in
interpret mode and against the JAX f32 ``MomentumKernel.matvec`` at
2e-5 max|ref| (the f32 element sums run in another order).  The f64 pieces
(strain, internal force, matvec, batched 6x6 apply, body force) agree at
1e-12 max|ref|: only the summation order of the cumsum scatter differs.
The CUDA kernel itself runs only on a GPU: its test needs the card and
skips here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from safeincave_tpu.fem.bandkernel import BandMatvec as JaxBandMatvec
from safeincave_tpu.fem.bandplan import BandPlan
from safeincave_tpu.fem.kernels import MomentumKernel as JaxKernel
from safeincave_tpu.mesh.boxgen import GridBox as JaxGridBox
from safeincave_tpu.mesh.reorder import reordered_grid as jax_reordered
from safeincave_torch.fem.bandkernel import BandMatvec, band_matvec_plain
from safeincave_torch.fem.kernels import MomentumKernel
from safeincave_torch.mesh.boxgen import GridBox
from safeincave_torch.mesh.reorder import reordered_grid

torch.set_num_threads(1)

NX = 3


@pytest.fixture(scope="module")
def grids():
    dims = dict(Lx=1.0, Ly=2.0, Lz=1.5, nx=NX, ny=NX, nz=NX)
    g_port = reordered_grid(GridBox(**dims), method="band")[0]
    g_jax = jax_reordered(JaxGridBox(**dims), method="band")[0]
    return g_port, g_jax


def _random_ct(E, rng, energy_symmetric=False):
    """Random SPD-ish per-element tangent (E, 6, 6)."""
    M = rng.normal(size=(E, 6, 6))
    CT = 0.5 * (M + np.transpose(M, (0, 2, 1))) + 8.0 * np.eye(6)
    if energy_symmetric:
        # A is symmetric when CT = w^-1 CT^T w, w = diag(1,1,1,2,2,2)
        w = np.diag([1.0, 1, 1, 2, 2, 2])
        CT = 0.5 * (CT + np.linalg.inv(w) @ np.transpose(CT, (0, 2, 1)) @ w)
    return CT


def _soa32(CT):
    return np.ascontiguousarray(np.transpose(CT, (1, 2, 0))).astype(
        np.float32)


def test_band_plain_matches_pallas_and_xla(grids):
    g_port, g_jax = grids
    rng = np.random.default_rng(2)
    CT = _random_ct(g_port.n_elems, rng)
    u = rng.normal(size=(g_port.n_nodes, 3)).astype(np.float32)

    kern = MomentumKernel(g_port, "cpu")
    band = kern.enable_band()
    ctv = band.pack_ct(torch.as_tensor(_soa32(CT)))
    got = band.matvec(ctv, torch.as_tensor(u)).numpy()
    assert band.launches == 0          # CPU tensors never launch the kernel

    jk = JaxKernel(g_jax)
    ref_xla = np.asarray(jk.matvec(jnp.asarray(_soa32(CT)), jnp.asarray(u)))
    jb = JaxBandMatvec(BandPlan.build(np.asarray(g_jax.conn), g_jax.n_nodes),
                       interpret=True)
    ref_pallas = np.asarray(jb.matvec(
        jb.pack_ct(jnp.asarray(_soa32(CT)),
                   jnp.asarray(g_jax.volumes, jnp.float32)),
        jb.pack_gn(jnp.asarray(g_jax.grad_N, jnp.float32)), jnp.asarray(u)))
    for ref in (ref_pallas, ref_xla):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max())


def test_band_plain_energy_symmetry(grids):
    """u^T A v == v^T A u for an energy-symmetric tangent."""
    g_port, _ = grids
    rng = np.random.default_rng(3)
    CT = _random_ct(g_port.n_elems, rng, energy_symmetric=True)
    band = MomentumKernel(g_port, "cpu").enable_band()
    ctv = band.pack_ct(torch.as_tensor(_soa32(CT)))
    u = torch.as_tensor(rng.normal(size=(g_port.n_nodes, 3)),
                        dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(g_port.n_nodes, 3)),
                        dtype=torch.float32)
    a = float((v * band.matvec(ctv, u)).sum())
    b = float((u * band.matvec(ctv, v)).sum())
    assert abs(a - b) < 1e-3 * max(abs(a), 1.0)


def test_f64_kernel_pieces_match_jax(grids):
    g_port, g_jax = grids
    rng = np.random.default_rng(4)
    E, N = g_port.n_elems, g_port.n_nodes
    CT = _random_ct(E, rng)
    u = rng.normal(size=(N, 3))
    sig = rng.normal(size=(E, 6))
    rho = rng.uniform(1e3, 3e3, size=E)
    kern, jk = MomentumKernel(g_port, "cpu"), JaxKernel(g_jax)
    CT_p = kern.prep(torch.as_tensor(CT))
    CT_j = jk.prep(jnp.asarray(CT))
    pairs = [
        (kern.matvec(CT_p, torch.as_tensor(u)), jk.matvec(CT_j,
                                                          jnp.asarray(u))),
        (kern.strain(torch.as_tensor(u)), jk.strain(jnp.asarray(u))),
        (kern.internal_force(torch.as_tensor(sig)),
         jk.internal_force(jnp.asarray(sig))),
        (kern.apply66(CT_p, torch.as_tensor(sig)),
         jk.apply66(CT_j, jnp.asarray(sig))),
        (kern.body_force(rho, [0.0, 1.0, -9.81]),
         jk.body_force(jnp.asarray(rho), [0.0, 1.0, -9.81])),
        (torch.as_tensor(kern.block_diagonal(CT)), jk.block_diagonal(CT)),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


def test_plain_twin_is_the_f32_element_operator(grids):
    """band_matvec_plain with vol folded into CT equals the f32 cumsum
    matvec of the same kernel (the same sums in the same order, up to where
    the volume multiplies in)."""
    g_port, _ = grids
    rng = np.random.default_rng(5)
    kern = MomentumKernel(g_port, "cpu")
    CT = torch.as_tensor(_soa32(_random_ct(g_port.n_elems, rng)))
    u = torch.as_tensor(rng.normal(size=(g_port.n_nodes, 3)),
                        dtype=torch.float32)
    gN, vol = kern.geom(torch.float32)
    got = band_matvec_plain((CT * vol).reshape(36, -1), gN.reshape(12, -1),
                            kern.conn, kern.plan, u)
    ref = kern.matvec(CT, u)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=2e-5 * ref.abs().max().item())


@pytest.mark.gpu
def test_cuda_kernel_matches_plain(grids):
    """The CUDA band kernel vs its plain twin on the card: 2e-5 max|ref|,
    bitwise-repeatable, and one counted launch per matvec."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    g_port, _ = grids
    rng = np.random.default_rng(6)
    kern = MomentumKernel(g_port, "cuda")
    band = BandMatvec(kern)
    ctv = band.pack_ct(torch.as_tensor(_soa32(_random_ct(g_port.n_elems,
                                                          rng)),
                                       device="cuda"))
    u = torch.as_tensor(rng.normal(size=(g_port.n_nodes, 3)),
                        dtype=torch.float32, device="cuda")
    got = band.matvec(ctv, u)
    again = band.matvec(ctv, u)
    torch.cuda.synchronize()
    ref = band_matvec_plain(ctv, band.gN, band.conn, band.plan, u)
    assert band.launches == 2
    assert torch.equal(got, again)
    assert (got - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()
    with pytest.raises(ValueError):
        band.matvec(ctv.double(), u)
