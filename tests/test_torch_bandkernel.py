"""PyTorch port vs JAX package: the f32 band stiffness action and the f64
matrix-free kernel pieces.

On the CPU the port's ``BandMatvec`` runs its plain twin
(``band_matvec_plain``); it is held against the Pallas band kernel in
interpret mode and against the JAX f32 ``MomentumKernel.matvec`` at
2e-5 max|ref| (the f32 element sums run in another order).  The f64 pieces
(strain, internal force, matvec, batched 6x6 apply, body force) agree at
1e-12 max|ref|: only the summation order of the cumsum scatter differs.
The CUDA kernel itself runs only on a GPU: its test needs the card and
skips here.  What surrounds it does run here: the tile plan of its two-level
sum (``BandTilePlan``) is held to its invariants on cavern_proxy_600 and a
band-ordered box, and a numpy emulation of the kernel's sum, table by table,
to the plain twin at 1e-6 max|ref| in f32 and 1e-13 in f64 (the same element
maths; only the order of the node sums differs).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from safeincave_tpu.fem.bandkernel import BandMatvec as JaxBandMatvec
from safeincave_tpu.fem.bandplan import BandPlan
from safeincave_tpu.fem.kernels import MomentumKernel as JaxKernel
from safeincave_tpu.mesh.boxgen import GridBox as JaxGridBox
from safeincave_tpu.mesh.reorder import reordered_grid as jax_reordered
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_torch.fem.bandkernel import (BandMatvec, BandTilePlan,
                                             band_matvec_plain, tile_size)
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


def _plan_grid(name):
    """cavern_proxy_600 (band order, as the main path runs it), a
    band-ordered GridBox nx=4, and that box with its elements shuffled (the
    kernel is right for any element order, fast for band order)."""
    if name == "cavern600":
        return cfg.cavern600_grid(st)
    g = reordered_grid(GridBox(nx=4, ny=4, nz=4), method="band")[0]
    if name == "box4_shuffled":
        order = np.random.default_rng(9).permutation(g.n_elems)
        return SimpleNamespace(conn=np.asarray(g.conn)[order],
                               n_nodes=g.n_nodes, n_elems=g.n_elems,
                               grid=g, order=order)
    return g


def _tile_of_local(tp):
    """(tile, index within the tile) of every local node."""
    L = np.arange(len(tp.lnode))
    tile = np.searchsorted(tp.tile_lo, L, side="right") - 1
    return tile, L - tp.tile_lo[tile]


@pytest.mark.parametrize("name", ["cavern600", "box4", "box4_shuffled"])
def test_tile_plan_invariants(name):
    """Every (element, corner) is summed exactly once, into a local node of
    its own tile that stands for its own node; every node's partials lie
    contiguous and in tile order; the padding of the contribution table is
    zero."""
    g = _plan_grid(name)
    conn = np.asarray(g.conn, dtype=np.int64)
    E, T = conn.shape[0], 128
    tp = BandTilePlan(conn, g.n_nodes, T)
    assert tp.T == T == tile_size(E) and tp.n_tiles == -(-E // T)
    assert len(tp.contrib) == 4 * T * tp.n_tiles
    assert not tp.contrib[4 * E:].any()
    tile = np.arange(E) // T
    # corners: local ids of the element's own tile, standing for its nodes
    assert (tp.corner >= 0).all()
    assert (tp.corner < np.diff(tp.tile_lo)[tile][:, None]).all()
    np.testing.assert_array_equal(tp.lnode[tp.tile_lo[tile][:, None]
                                           + tp.corner], conn)
    # contributions: each (element, corner) once, grouped by local node
    l_tile, l_in = _tile_of_local(tp)
    seen = []
    for L in range(len(tp.lnode)):
        t = l_tile[L]
        k0 = tp.lend[L - 1] if l_in[L] else 0
        q = tp.contrib[4 * T * t + k0:4 * T * t + tp.lend[L]]
        assert len(q) > 0 and (np.diff(q) > 0).all()
        e, a = T * t + q // 4, q % 4
        assert (conn[e, a] == tp.lnode[L]).all()
        seen.append(4 * e + a)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  np.arange(4 * E))
    # partial slots: a permutation; each node's slots contiguous, in tile
    # order, and only its own local nodes
    np.testing.assert_array_equal(np.sort(tp.dst), np.arange(len(tp.lnode)))
    slot_local = np.empty_like(tp.dst)
    slot_local[tp.dst] = np.arange(len(tp.lnode))
    for n in range(g.n_nodes):
        Ls = slot_local[tp.pstart[n]:tp.pstart[n + 1]]
        assert (tp.lnode[Ls] == n).all()
        assert (np.diff(l_tile[Ls]) > 0).all()
    assert tp.pstart[-1] == len(tp.lnode)
    assert tp.max_local == np.diff(tp.tile_lo).max() <= 4 * T


def _emulate(tp, ctv, gN, u):
    """The band kernel's two-level sum in numpy, table by table: each
    element's forces from u staged at its tile's local nodes (corner ids),
    one partial per local node summed in the plan's order into its slot, and
    per node its partials in tile order."""
    E, T = tp.n_elems, tp.T
    tile = np.arange(E) // T
    ue = u[tp.lnode[tp.tile_lo[tile][:, None] + tp.corner]]      # (E, 4, 3)
    g = gN.reshape(4, 3, E).transpose(2, 0, 1)                    # (E, 4, 3)
    grad = np.einsum("eai,eaj->eij", ue, g)
    eps = np.stack([grad[:, 0, 0], grad[:, 1, 1], grad[:, 2, 2],
                    0.5 * (grad[:, 0, 1] + grad[:, 1, 0]),
                    0.5 * (grad[:, 0, 2] + grad[:, 2, 0]),
                    0.5 * (grad[:, 1, 2] + grad[:, 2, 1])], axis=1)
    sig = np.einsum("mke,ek->em", ctv.reshape(6, 6, E), eps)
    fe = np.einsum("ecj,eaj->eac", sig[:, [[0, 3, 4], [3, 1, 5], [4, 5, 2]]],
                   g)                                             # (E, 4, 3)
    l_tile, l_in = _tile_of_local(tp)
    partials = np.zeros((len(tp.lnode), 3), dtype=u.dtype)
    for L in range(len(tp.lnode)):
        base = 4 * T * l_tile[L]
        q = tp.contrib[base + (tp.lend[L - 1] if l_in[L] else 0):
                       base + tp.lend[L]]
        for k in q:
            partials[tp.dst[L]] += fe[T * l_tile[L] + k // 4, k % 4]
    f = np.zeros_like(u)
    for n in range(tp.n_nodes):
        for p in partials[tp.pstart[n]:tp.pstart[n + 1]]:
            f[n] += p
    return f


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-13)])
@pytest.mark.parametrize("name", ["cavern600", "box4", "box4_shuffled"])
def test_tile_plan_two_level_sum(name, dtype, tol):
    """The kernel's sum, emulated in numpy on the plan's tables, against
    band_matvec_plain (the cumsum scatter) on the same inputs."""
    g = _plan_grid(name)
    grid = getattr(g, "grid", g)
    kern = MomentumKernel(grid, "cpu")
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    gN, vol = kern.geom(tdt)
    rng = np.random.default_rng(10)
    CT = torch.as_tensor(_soa32(_random_ct(grid.n_elems, rng)), dtype=tdt)
    ctv = (CT * vol).reshape(36, -1)
    u = torch.as_tensor(rng.normal(size=(grid.n_nodes, 3)), dtype=tdt)
    ref = band_matvec_plain(ctv, gN.reshape(12, -1), kern.conn, kern.plan,
                            u).numpy()
    order = getattr(g, "order", np.arange(grid.n_elems))
    tp = BandTilePlan(np.asarray(grid.conn)[order], grid.n_nodes)
    got = _emulate(tp, ctv.numpy()[:, order], gN.reshape(12, -1).numpy()
                   [:, order], u.numpy())
    assert got.dtype == dtype
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


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
