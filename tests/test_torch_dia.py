"""PyTorch port vs JAX package: the block-DIA operator (fem/dia.py) and the
element block rows it is assembled from (fem/blockell.py).

Inputs are made from a numpy seed and handed to both packages on small
natural-order GridBoxes.  Tolerances:

- plan tables: equal;
- the padded layout: the port pads the planes' node axis to a multiple of 4
  (the CUDA kernel's 16-byte loads), the JAX package to its TPU tile; the
  first N columns agree at 1e-12 and every padding column is exactly zero;
- element rows and assemblies, f64: 1e-12 max|ref| (one batched product
  against the JAX package's elementwise sums; the general assembly reduces
  through the cumsum plan, whose prefix sums round at ~1e-14);
- the plain f64 matvec: 1e-12 against JAX's ``BlockDIA.matvec`` and the
  port's cumsum matvec (same operator, other summation order);
- the plain f32 matvec: 1e-6 max|ref| against JAX's Pallas kernel in
  interpret mode (f32 sums in another order).

The solver runs with ``enable_dia_matvec`` on both packages agree at 1e-8
relative with equal fixed-point rows, as the other slice tests do.  The CUDA
kernel runs only on a GPU: its test needs the card and skips here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_tpu.fem.blockell import (
    element_block_comp_rows as jax_comp_rows,
    element_block_rows as jax_rows)
from safeincave_tpu.fem.dia import BlockDIA as JaxBlockDIA
from safeincave_tpu.fem.kernels import MomentumKernel as JaxKernel
from safeincave_torch.fem.blockell import (element_block_comp_rows,
                                           element_block_rows)
from safeincave_torch.fem.dia import (BlockDIA, DIAPlan, StructuredPlan,
                                      dia_matvec_plain, padded_stride)
from safeincave_torch.fem.kernels import MomentumKernel
from safeincave_torch.fem.momentum import select_backend
from safeincave_torch.mesh.boxgen import GridBox
from safeincave_torch.mesh.reorder import reordered_grid

torch.set_num_threads(1)

DIMS = dict(Lx=2.0, Ly=1.0, Lz=1.5, nx=5, ny=4, nz=3)


@pytest.fixture(scope="module")
def pair():
    g_port, g_jax = GridBox(**DIMS), sc.GridBox(**DIMS)
    kern = MomentumKernel(g_port, "cpu")
    jk = JaxKernel(g_jax)
    return g_port, kern, BlockDIA(kern), jk, JaxBlockDIA(jk)


def _random_ct(E, seed):
    """Random SPD tangents (6, 6, E), f64."""
    A = np.random.default_rng(seed).normal(size=(E, 6, 6))
    CT = np.einsum("eij,ekj->eik", A, A) + 6 * np.eye(6)[None]
    return np.ascontiguousarray(np.moveaxis(CT, 0, -1))


def _close(got, want, rtol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=what)


def test_plans_match_jax(pair):
    g, _, dia, _, jdia = pair
    p, jp = dia.plan, jdia.plan
    np.testing.assert_array_equal(p.offsets, jp.offsets)
    np.testing.assert_array_equal(p.row_slot, jp.row_slot)
    assert (p.Dn, p.n_pairs, p.fill) == (jp.Dn, jp.n_pairs, jp.fill)
    assert p.Dn == 15
    assert dia.structured and jdia._sp is not None
    sp, jsp = dia._sp, jdia._sp
    assert (sp.nx, sp.ny, sp.nz) == (jsp.nx, jsp.ny, jsp.nz) == (5, 4, 3)
    assert sp.table == jsp.table and len(sp.table) == 96


@pytest.mark.parametrize("layout", ["rows", "comp_rows"])
def test_element_rows_match_jax(pair, layout):
    g, *_ = pair
    CT = _random_ct(g.n_elems, 0)
    gn = np.ascontiguousarray(np.moveaxis(np.asarray(g.grad_N), 0, -1))
    vol = np.asarray(g.volumes)
    port_fn, jax_fn = {"rows": (element_block_rows, jax_rows),
                       "comp_rows": (element_block_comp_rows,
                                     jax_comp_rows)}[layout]
    got = port_fn(torch.as_tensor(CT), torch.as_tensor(gn),
                  torch.as_tensor(vol))
    want = np.asarray(jax_fn(jnp.asarray(CT), gn, vol))
    assert tuple(got.shape) == want.shape
    assert got.dtype == torch.float64
    _close(got, want, 1e-12, layout)


@pytest.mark.parametrize("path", ["structured", "scatter"])
def test_assembly_matches_jax(pair, path):
    """Both assemblies against JAX's ``BlockDIA.assemble`` (the first N
    columns: the two packages pad to different strides), and against each
    other."""
    g, kern, _, _, jdia = pair
    N = g.n_nodes
    CT = _random_ct(g.n_elems, 1)
    want = np.asarray(jdia.assemble(jnp.asarray(CT)))[:, :N]
    dia = BlockDIA(kern)
    if path == "scatter":
        dia._sp = None
    got = dia.assemble(torch.as_tensor(CT))
    assert tuple(got.shape) == (15 * 9, padded_stride(N))
    _close(got[:, :N], want, 1e-12, path)
    other = BlockDIA(kern)
    if path == "structured":
        other._sp = None
    _close(got, other.assemble(torch.as_tensor(CT)), 1e-12, "other path")


@pytest.mark.parametrize("path", ["structured", "scatter"])
def test_padded_layout_matches_jax(path):
    """The planes' node axis is padded with zero columns: by the port to a
    multiple of 4 (N = 125 here, so 3 columns), by the JAX package to its
    TPU tile (Npad).  The first N columns agree and every padding column is
    exactly zero (in f32 too, whose values the f32 kernel tests hold)."""
    dims = dict(Lx=1.0, Ly=1.0, Lz=1.0, nx=4, ny=4, nz=4)
    g, jk = GridBox(**dims), JaxKernel(sc.GridBox(**dims))
    N = g.n_nodes
    dia, jdia = BlockDIA(MomentumKernel(g, "cpu")), JaxBlockDIA(jk)
    if path == "scatter":
        dia._sp = None
    assert dia.ld == padded_stride(N) == 128 and dia.ld % 4 == 0
    CT = _random_ct(g.n_elems, 11)
    want = np.asarray(jdia.assemble(jnp.asarray(CT)))
    assert want.shape[1] >= dia.ld and not want[:, N:].any()
    for dtype in (torch.float64, torch.float32):
        got = dia.assemble(torch.as_tensor(CT, dtype=dtype))
        assert got.dtype == dtype and tuple(got.shape) == (135, dia.ld)
        assert got.is_contiguous() and not got[:, N:].any()
        if dtype == torch.float64:
            _close(got[:, :N], want[:, :N], 1e-12, path)


def test_plain_matvec_reads_no_padding():
    """dia_matvec_plain on the padded planes gives its result on their first
    N columns (to 1e-15; it reads no padding column)."""
    g = GridBox(Lx=1.0, Ly=1.0, Lz=1.0, nx=4, ny=4, nz=4)
    dia = BlockDIA(MomentumKernel(g, "cpu"))
    vals = dia.assemble(torch.as_tensor(_random_ct(g.n_elems, 12)))
    assert vals.shape[1] > g.n_nodes
    vals[:, g.n_nodes:] = 1e300          # any padding value is ignored
    u = torch.as_tensor(np.random.default_rng(13).normal(size=(g.n_nodes,
                                                               3)))
    want = dia_matvec_plain(vals[:, :g.n_nodes].contiguous(), u,
                            dia.offsets, g.n_nodes)
    _close(dia_matvec_plain(vals, u, dia.offsets, g.n_nodes), want, 1e-15,
           "padded vs first N columns")


def test_plain_matvec_f64_matches_jax_and_cumsum(pair):
    g, kern, dia, jk, jdia = pair
    CT = _random_ct(g.n_elems, 2)
    u = np.random.default_rng(3).normal(size=(g.n_nodes, 3))
    vals = dia.assemble(torch.as_tensor(CT))
    got = dia.matvec(vals, torch.as_tensor(u))
    assert dia.launches == 0           # CPU tensors never launch the kernel
    want = np.asarray(jdia.matvec(jdia.assemble(jnp.asarray(CT)),
                                  jnp.asarray(u)))
    _close(got, want, 1e-12, "vs JAX BlockDIA.matvec")
    cumsum = kern.matvec(torch.as_tensor(CT), torch.as_tensor(u))
    _close(got, cumsum, 1e-12, "vs the port's cumsum matvec")
    _close(got, np.asarray(jk.matvec(jnp.asarray(CT), jnp.asarray(u))),
           1e-12, "vs JAX's cumsum matvec")


def test_plain_matvec_f32_matches_pallas_interpret():
    dims = dict(Lx=1.0, Ly=1.0, Lz=1.0, nx=4, ny=4, nz=4)
    g, jk = GridBox(**dims), JaxKernel(sc.GridBox(**dims))
    jdia = JaxBlockDIA(jk, interpret=True)
    assert jdia._pallas_call is not None
    CT = _random_ct(g.n_elems, 4)
    vals64 = np.asarray(jdia.assemble(jnp.asarray(CT)))
    vals = vals64.astype(np.float32)
    u = np.random.default_rng(5).normal(size=(g.n_nodes, 3)).astype(
        np.float32)
    want = np.asarray(jdia.matvec(jnp.asarray(vals), jnp.asarray(u)))
    dia = BlockDIA(MomentumKernel(g, "cpu"))
    got = dia.matvec(torch.as_tensor(vals[:, :g.n_nodes]), torch.as_tensor(u))
    assert got.dtype == torch.float32
    _close(got, want, 1e-6, "vs the Pallas kernel (interpret)")
    # the same plain function, called directly, is what the wrapper ran
    _close(dia_matvec_plain(torch.as_tensor(vals[:, :g.n_nodes]),
                            torch.as_tensor(u), dia.offsets, g.n_nodes),
           got.numpy(), 0.0, "wrapper vs dia_matvec_plain")
    with pytest.raises(ValueError):
        dia.matvec(torch.as_tensor(vals[:, :g.n_nodes]),
                   torch.as_tensor(u, dtype=torch.float64))


def test_refuses_permuted_numbering():
    """A randomly permuted box numbering is not offset-structured (the port
    has no Morton reordering to test with); the structured inference
    refuses it too."""
    g = GridBox(Lx=1.0, Ly=1.0, Lz=1.0, nx=5, ny=5, nz=5)
    perm = np.random.default_rng(6).permutation(g.n_nodes)
    conn = perm[np.asarray(g.conn)]
    with pytest.raises(ValueError, match="offset-structured"):
        DIAPlan(conn, g.n_nodes)
    with pytest.raises(ValueError):
        StructuredPlan(conn, g.n_nodes, DIAPlan(np.asarray(g.conn),
                                                g.n_nodes).offsets)


def test_backend_selection_by_device():
    """LinearMomentum's auto-selection: block-DIA for a natural-order box
    and band for a band-ordered grid on CUDA, as the JAX package selects on
    an accelerator; nothing on the CPU, as the JAX package on its CPU."""
    box = GridBox(nx=3, ny=3, nz=3)
    band = reordered_grid(box, method="band")[0]
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert select_backend(box, cuda) == "dia"
    assert select_backend(band, cuda) == "band"
    assert select_backend(box, cpu) is None
    assert select_backend(band, cpu) is None


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """The CUDA DIA kernel vs its plain twin on the card, f32 and f64:
    1e-5 max|ref| (f32 sums in another order), bitwise repeatable, one
    counted launch per matvec, and a refusal of a mismatched dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
    g = GridBox(**DIMS)
    dia = BlockDIA(MomentumKernel(g, "cuda"))
    CT = _random_ct(g.n_elems, 7)
    u = np.random.default_rng(8).normal(size=(g.n_nodes, 3))
    for n, dtype in enumerate((torch.float32, torch.float64)):
        vals = dia.assemble(torch.as_tensor(CT, dtype=dtype, device="cuda"))
        ut = torch.as_tensor(u, dtype=dtype, device="cuda")
        got, again = dia.matvec(vals, ut), dia.matvec(vals, ut)
        torch.cuda.synchronize()
        ref = dia_matvec_plain(vals, ut, dia.offsets, g.n_nodes)
        assert dia.launches == 2 * (n + 1)
        assert torch.equal(got, again)
        assert (got - ref).abs().max().item() <= \
            1e-5 * ref.abs().max().item()
    with pytest.raises(ValueError):
        dia.matvec(vals, ut.float())


@pytest.mark.parametrize("branch", ["structured", "general"])
def test_dia_solver_matches_jax(branch):
    """``enable_dia_matvec`` on both packages, fp32 phase off, the bench's
    material and loads on a natural-order box: the elastic response and 2
    steps agree at 1e-8 relative with equal [iterations, converged] rows.
    "general" forces the scatter assembly, whose f64 planes then carry the
    f64 action too."""
    out = {}
    for name, pkg in (("jax", sc), ("port", st)):
        eq = cfg.wire_bench(pkg, pkg.GridBox(Lx=600.0, Ly=600.0, Lz=800.0,
                                             nx=3, ny=3, nz=3),
                             device="cpu")
        eq.enable_dia_matvec()
        if branch == "general":
            eq.kernel.dia._sp = None
        cfg.elastic_init(eq)
        u_el = np.asarray(eq.u)
        rows = eq.solve_time_steps([cfg.HOUR, 2 * cfg.HOUR],
                                   [cfg.HOUR] * 2, tol=1e-8, maxiter=40)
        out[name] = [u_el, np.asarray(rows)] + [
            np.asarray(getattr(eq, k)) for k in ("u", "sig_v", "eps_tot_v")]
    j, p = out["jax"], out["port"]
    assert (j[1][:, 5] == 1).all()
    np.testing.assert_array_equal(p[1][:, [0, 5]], j[1][:, [0, 5]])
    for what, got, want in zip(("elastic u", "u", "sig_v", "eps_tot_v"),
                               p[:1] + p[2:], j[:1] + j[2:]):
        np.testing.assert_allclose(got, want, rtol=1e-8,
                                   atol=1e-8 * np.abs(want).max(),
                                   err_msg=what)
