"""The dense preconditioner's packed symmetric inverse (fem/symdense.py) on
the CPU: the pack of ``0.5 (inv + inv^T)`` into B x B tiles of its upper
triangle, the plain twin of the kernel's apply, the host plan of the
kernel's two-pass sum, and the preconditioner and the solves it drives
against the JAX package and the full inverse it replaces.  The kernel
itself runs on the card (tests/test_torch_kernels_gpu.py).
"""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_tpu.fem.momentum import build_preconditioner as jax_precond
from safeincave_torch.fem import momentum
from safeincave_torch.fem.momentum import (_dense_inverse_precond,
                                           build_preconditioner)
from safeincave_torch.fem.symdense import (B, NC, SymDense, SymPlan,
                                           chunk_index, n_blocks, n_chunks,
                                           pack_upper, sym_dense_plain)

torch.set_num_threads(1)

# n a multiple of B, ragged, smaller than B
SIZES = [2 * B, 2 * B + 44, B - 28]


def _inverse(n, seed):
    """A random unsymmetric f32 'inverse' and its symmetrized matrix."""
    g = torch.Generator().manual_seed(seed)
    inv = torch.randn((n, n), generator=g)
    return inv, 0.5 * (inv + inv.T)


def _unpack(tiles, n):
    """The (n, n) symmetric matrix whose upper triangle ``tiles`` holds."""
    nb = n_blocks(n)
    full = torch.zeros((nb * B, nb * B))
    rows, cols = chunk_index(n)
    for k, (I, j) in enumerate(zip(rows.tolist(), cols.tolist())):
        full[I * B:(I + 1) * B, 32 * j:32 * (j + 1)] = tiles[k]
        if j >= NC * (I + 1):
            full[32 * j:32 * (j + 1), I * B:(I + 1) * B] = tiles[k].T
    return full[:n, :n]


@pytest.mark.parametrize("n", SIZES)
def test_unpack_gives_the_symmetrized_inverse(n):
    inv, P = _inverse(n, n)
    tiles = pack_upper(inv)
    assert tiles.shape == (n_chunks(n), B, 32)
    assert torch.equal(_unpack(tiles, n), P)
    assert torch.equal(P, P.T)
    # the ragged edge is zero
    rows, cols = chunk_index(n)
    for k, (I, j) in enumerate(zip(rows, cols)):
        r = torch.arange(B) + I * B
        c = torch.arange(32) + 32 * j
        outside = (r[:, None] >= n) | (c[None, :] >= n)
        assert not tiles[k][outside].any()


@pytest.mark.parametrize("n", SIZES)
def test_plain_twin_is_the_symmetric_product(n):
    inv, P = _inverse(n, n + 1)
    x = torch.randn(n, generator=torch.Generator().manual_seed(n))
    got = sym_dense_plain(pack_upper(inv), n, x)
    want = P.double() @ x.double()
    assert got.dtype == torch.float32 and got.shape == (n,)
    # f32 sums of n products of O(1): a few n eps of the largest entry
    tol = 4 * n * torch.finfo(torch.float32).eps * float(
        (P.abs().double() @ x.abs().double()).max())
    assert float((got.double() - want).abs().max()) <= tol


@pytest.mark.parametrize("n,sms", [(300, 1), (300, 5), (1000, 132),
                                   (100, 132), (10080, 132), (23007, 132)])
def test_plan_covers_every_partial_once(n, sms):
    """Walk the kernel's bookkeeping on the host: every block's run, its
    row-partial slots and the column-partial slots it computes, as
    csrc/sym_dense_matvec.cu does them."""
    plan = SymPlan(n, sms)
    P, nb, K = NC, plan.nb, plan.n_chunks
    rows, cols = chunk_index(n)
    assert plan.grid == min(sms, K)
    row_slots = {}
    col_slots = []
    for b in range(plan.grid):
        k0, k1 = K * b // plan.grid, K * (b + 1) // plan.grid
        assert k1 > k0
        I, seg = int(plan.cta_row[b]), int(plan.cta_seg[b])
        j = P * I + (k0 - P * (I * nb - I * (I - 1) // 2))
        for k in range(k0, k1):
            assert (rows[k], cols[k]) == (I, j)
            row_slots.setdefault(I, set()).add(seg)
            if j >= P * (I + 1):
                q, s = divmod(j, P)
                col_slots.append(P * (q * (q - 1) // 2) + s * q + I)
            j += 1
            if j == P * nb or k == k1 - 1:
                seg += 1
                if j == P * nb:
                    I, j = I + 1, P * (I + 1)
        assert seg == plan.cta_seg[b + 1]
    assert plan.n_seg == plan.cta_seg[-1]
    for I in range(nb):
        assert row_slots[I] == set(range(plan.seg_row[I],
                                         plan.seg_row[I + 1]))
    assert sorted(col_slots) == list(range(plan.n_off))


def test_sym_dense_on_the_cpu_is_the_plain_twin():
    n = 300
    inv, _ = _inverse(n, 3)
    sym = SymDense(inv)
    x = torch.randn(n, generator=torch.Generator().manual_seed(4))
    assert sym.shape == (n, n)
    assert torch.equal(sym(x), sym_dense_plain(sym.tiles, n, x))
    assert sym.launches == 0            # no kernel on the CPU


def _box(pkg):
    return pkg.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=3, ny=3, nz=3)


def test_dense_apply_matches_jax(monkeypatch):
    """``build_preconditioner(precond="dense")``: the packed symmetrized
    inverse applied in f32 and f64 within 1e-4 max|ref| of the JAX
    package's apply of its full inverse (the two f32 inversions round
    differently: tests/test_torch_momentum.py).  The JAX package's dense
    build reads ``os`` without importing it: the test lends it the
    module and leaves its disk cache off."""
    import safeincave_tpu.fem.momentum as jax_momentum
    monkeypatch.setattr(jax_momentum, "os", os, raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    eq_p = cfg.wire_bench(st, _box(st), precond="dense", device="cpu")
    eq_p.bc.update_dirichlet(0.0)
    eq_j = cfg.wire_bench(sc, _box(sc), precond="dense")
    eq_j.bc.update_dirichlet(0.0)
    (sym,), apply_p = build_preconditioner(
        eq_p.kernel, eq_p.mat.C, eq_p.bc.mask,
        st.SolverSettings(precond="dense"))
    P_j, apply_j = jax_precond(eq_j.kernel, eq_j.mat.C, eq_j.bc.mask,
                               sc.SolverSettings(precond="dense"))
    assert isinstance(sym, SymDense) and sym.shape[0] == 3 * eq_p.n_nodes
    r = np.random.default_rng(2).normal(size=(eq_p.n_nodes, 3))
    for dt_t, dt_j in ((torch.float32, jnp.float32),
                       (torch.float64, jnp.float64)):
        z_p = apply_p((sym,), torch.as_tensor(r).to(dt_t), None)
        z_j = np.asarray(apply_j(P_j, jnp.asarray(r, dtype=dt_j), None))
        assert z_p.dtype == dt_t and z_p.shape == r.shape
        np.testing.assert_allclose(z_p.numpy(), z_j, rtol=0,
                                   atol=1e-4 * np.abs(z_j).max())


class _FullInverse:
    """The apply this preconditioner replaced: ``torch.mv`` over the whole
    unsymmetrized inverse."""

    def __init__(self, inv):
        self.inv = inv

    def __call__(self, x):
        return torch.mv(self.inv, x)


def test_solve_matches_the_full_inverse(monkeypatch):
    """Two steps preconditioned by the packed symmetrized inverse give the
    fields of the same steps preconditioned by the full unsymmetrized one
    at 1e-8 (the preconditioner moves the iteration count, not the
    solution)."""
    fields = {}
    for packed in (True, False):
        if not packed:
            monkeypatch.setattr(momentum, "SymDense", _FullInverse)
        eq = cfg.wire_bench(st, _box(st), precond="dense", device="cpu")
        eq.set_solver(st.SolverSettings(precond="dense", fp32_phase=False,
                                        **cfg.SETTINGS))
        cfg.elastic_init(eq)
        rows = eq.solve_time_steps([cfg.HOUR, 2 * cfg.HOUR],
                                   [cfg.HOUR] * 2, tol=1e-8, maxiter=40)
        assert (rows[:, 5] == 1).all()
        assert isinstance(eq._get_precond()[0][0],
                          SymDense if packed else _FullInverse)
        fields[packed] = (eq.u.numpy(), eq.sig_v.numpy())
    for a, b in zip(fields[True], fields[False]):
        np.testing.assert_allclose(a, b, rtol=1e-8,
                                   atol=1e-8 * np.abs(b).max())


def test_bf16_path_keeps_the_full_inverse():
    """``precond_bf16`` keeps its own path: the whole unsymmetrized inverse
    in bfloat16, bit for bit the dense build's cast."""
    eq = cfg.wire_bench(st, _box(st), precond="dense", device="cpu")
    eq.bc.update_dirichlet(0.0)
    C = eq.mat.C.numpy()
    mask = eq.bc.mask.numpy()
    (inv16,), apply = build_preconditioner(
        eq.kernel, C, mask, st.SolverSettings(precond="dense",
                                              precond_bf16=True))
    assert apply.__name__ == "apply_dense_bf16"
    want = _dense_inverse_precond(eq.kernel, C, mask).to(torch.bfloat16)
    assert inv16.dtype == torch.bfloat16 and torch.equal(inv16, want)


def test_counters_carry_the_precond_launches():
    eq = cfg.wire_bench(st, _box(st), precond="dense", device="cpu")
    assert eq.counters()["precond_launches"] == 0
    cfg.elastic_init(eq)
    assert eq._sym_dense() is eq._get_precond()[0][0]
    assert eq.counters()["precond_launches"] == 0   # the plain twin on CPU
