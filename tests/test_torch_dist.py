"""The port's parallel layer on several ranks: D parts over W processes,
gloo on the CPU, through ``safeincave_torch.parallel.dist.launch``.

The rank bodies live in tests/torch_dist_worker.py (no JAX in the children);
the stacked port (all D parts in this process) and the JAX package (D of
tests/conftest.py's 8 virtual CPU devices) run here on the same numpy
inputs, while the ranks run.  Every inter-rank message of the halo layer
tests is checked for shape and dtype on both ends
(``torch_dist_worker.CheckedComm``).

1. the halo rounds on GridBox nx=6, D = 4 over W = 2 and 4, D = 8 over 4:
   forward and reverse equal to the stacked ``_fwd_exchange`` /
   ``_rev_exchange`` bit for bit, f64 and f32;
2. the halo matvec (f64, f32) and block diagonal on the same meshes: 1e-13
   of the stacked port, and tests/test_torch_halo.py's tolerances against
   JAX's ``HaloMomentumSolver`` over 4 devices (1e-12; f32 2e-5 of the f64
   action) for D = 4 (JAX compiles the 8-device programs for a minute;
   the stacked port holds D = 8 against JAX in tests/test_torch_halo.py's
   shard_equation case);
3. ``shard_equation(mode="halo")`` on the sharding cube over GridBox nx=6,
   D = 4 on W = 4, elastic response and 2 steps: u and sig_v within 1e-10
   of max|ref| of the stacked port and of JAX's ``shard_equation``,
   fixed-point counts equal;
4. ``mode="psum"`` on GridBox nx=3, D = 4 on W = 4, the same criteria;
4b. the f32 sweep (``fp32_phase=True``: ``make_halo_solve32`` in halo
   mode, the f32 solve on the summed assembly in psum mode) on GridBox
   nx=3, D = 4 on W = 4: fixed-point counts and accepted sweeps equal to
   the stacked port's, u and sig_v within 1e-8 of max|ref| of the stacked
   port and of JAX's ``shard_equation`` with the same flag (the sweep's f32
   inner products sum over the ranks in another order, and the fixed point
   stops at 1e-8; tests/test_torch_halo.py holds W = 1 against JAX at
   rtol 1e-8);
5. ``shard_tm`` of ``tm_cube``, D = 4 on W = 2: u, sig_v and T within 1e-10
   of max|ref| of the stacked port, counts equal;
6. the checkpoint of test 3's 4-rank run (rank 0 writes) equals the
   stacked run's to 1e-10, loads into an unsharded equation, and loads
   back into a 4-rank equation that saves it again bit for bit;
7. guards: D not a multiple of W raises, ``init_parts()`` without a card
   and without ``device="cpu"`` raises, a collective one rank never
   reaches raises within the group timeout, and ``launch`` kills ranks
   that outlive its timeout.
"""
import functools
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import safeincave_tpu as sc
import safeincave_torch as st
import torch_dist_worker as worker
import torch_port_configs as cfg
from safeincave_tpu.parallel import halo as jhalo
from safeincave_tpu.parallel import make_device_mesh as jax_mesh
from safeincave_tpu.parallel import shard_equation as jax_shard
from safeincave_torch.parallel import dist, halo as thalo
from safeincave_torch.parallel import make_device_mesh, shard_equation, shard_tm

torch.set_num_threads(1)

NX = 6
LAUNCH_S = 240.0


def _run(fn, world, *args, **kw):
    return dist.launch(fn, world, device="cpu", args=args,
                       timeout=kw.pop("timeout", LAUNCH_S), **kw)


def _run_beside(ref, fn, world, *args):
    """(ranks' results, ``ref()``): the references computed here while the
    ranks run."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_run, fn, world, *args)
        want = ref()
        return ranks.result(), want


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


def _stacked_solver(D):
    return thalo.HaloMomentumSolver(st.GridBox(nx=NX, ny=NX, nz=NX),
                                    make_device_mesh(D, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_halo(D):
    """JAX's matvec (whole) and block diagonal (owner rows) of the worker's
    inputs over D virtual devices."""
    grid = sc.GridBox(nx=NX, ny=NX, nz=NX)
    CT, u, mask = worker.halo_inputs(grid)
    ref = jhalo.HaloMomentumSolver(grid, jax_mesh(D))
    J = jnp.asarray
    CT_l = ref.ct_to_local(J(CT))
    y = ref.from_padded(ref.matvec_padded(CT_l, ref.to_padded(J(u)),
                                          ref.to_padded(J(mask))))
    return np.asarray(y), np.asarray(ref.block_diagonal_padded(CT_l))


CONFIGS = [(4, 2), (4, 4), (8, 4)]


@pytest.fixture(scope="module")
def halo_runs():
    """{(D, W): the ranks' results} of every configuration, the JAX
    reference compiled here meanwhile."""
    def all_configs():
        return {c: _run(worker.halo_layer, c[1], NX, c[0]) for c in CONFIGS}

    with ThreadPoolExecutor(1) as pool:
        runs = pool.submit(all_configs)
        _jax_halo(4)
        return runs.result()


@pytest.fixture(params=CONFIGS, ids=lambda p: f"D{p[0]}W{p[1]}")
def halo_run(request, halo_runs):
    D, W = request.param
    return D, W, halo_runs[request.param]


def test_exchange_rounds_bitwise(halo_run):
    D, W, ranks = halo_run
    ref = _stacked_solver(D)
    u_own, f_halo = worker.exchange_inputs(ref.plan)
    T = torch.as_tensor
    fwd = ref._fwd_exchange(T(u_own)).numpy()
    rev = ref._rev_exchange(T(f_halo), (3,)).numpy()
    fwd32 = ref._fwd_exchange(T(u_own).float()).numpy()
    Dl = D // W
    for r, out in enumerate(ranks):
        parts = slice(r * Dl, (r + 1) * Dl)
        assert out["fwd32"].dtype == np.float32
        for key, full in (("fwd", fwd), ("rev", rev), ("fwd32", fwd32)):
            np.testing.assert_array_equal(out[key], full[parts], key)
    # the inter-rank messages went through the shape and dtype check
    assert sum(out["checked"] for out in ranks) > 0
    assert all(out["rows_sent"] > 0 for out in ranks)


def test_halo_matvec_and_block_diagonal(halo_run):
    D, W, ranks = halo_run
    ref = _stacked_solver(D)
    CT, u, mask = worker.halo_inputs(ref.grid)
    T = torch.as_tensor
    CT_l = ref.ct_to_local(T(CT))
    mp = ref.to_padded(T(mask))
    y = ref.from_padded(ref.matvec_padded(CT_l, ref.to_padded(T(u)), mp))
    blk = ref.block_diagonal_padded(CT_l).numpy()
    for out in ranks:
        # the whole vector, the same bits on every rank
        np.testing.assert_array_equal(out["matvec"], ranks[0]["matvec"])
        assert _rel(out["matvec"], y) <= 1e-13
        assert out["matvec32"].dtype == np.float32
        assert _rel(out["matvec32"], y) <= 2e-5
    blk_d = np.concatenate([out["blockdiag"] for out in ranks])
    assert _rel(blk_d, blk) <= 1e-13
    if D == 4:
        y_jax, blk_jax = _jax_halo(D)
        for out in ranks:
            assert _rel(out["matvec"], y_jax) <= 1e-12
            assert _rel(out["matvec32"], y_jax) <= 2e-5
        assert _rel(blk_d, blk_jax) <= 1e-12


def _stacked_steps(mode, nx, D, fp32_phase=False):
    eq = cfg.sharding_box(st, nx=nx, device="cpu", fp32_phase=fp32_phase)
    shard_equation(eq, make_device_mesh(D, device="cpu"), mode=mode)
    u, _, rows = cfg.run_sharding_steps(eq)
    return eq, u, st.utils.unpad_elems(eq, eq.sig_v), rows


def _jax_steps(mode, nx, D, fp32_phase=False):
    eq = cfg.sharding_box(sc, nx=nx, fp32_phase=fp32_phase)
    n = eq.n_elems
    jax_shard(eq, jax_mesh(D), mode=mode)
    u, sig, rows = cfg.run_sharding_steps(eq)
    return u, sig[:n], rows


def _held(ranks, u, sig, rows, tol=1e-10):
    for out in ranks:
        np.testing.assert_array_equal(out["u"], ranks[0]["u"])
        np.testing.assert_array_equal(out["rows"][:, 0], rows[:, 0])
        assert out["sig"].shape == sig.shape
        assert _rel(out["u"], u) <= tol
        assert _rel(out["sig"], sig) <= tol


def test_shard_equation_halo_and_checkpoint(tmp_path):
    D = W = 4
    ranks, ((eq, u, sig, rows), ref) = _run_beside(
        lambda: (_stacked_steps("halo", NX, D), _jax_steps("halo", NX, D)),
        worker.sharded_steps, W, "halo", NX, D, False, str(tmp_path))
    assert ranks[0]["n_local"] == eq.n_elems // W
    _held(ranks, u, sig, rows)
    _held(ranks, *ref)

    # the 4-rank checkpoint against the stacked run's
    st.save_checkpoint(str(tmp_path / "stacked.npz"), eq)
    with np.load(tmp_path / "ck.npz") as got, \
            np.load(tmp_path / "stacked.npz") as ref:
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            assert got[k].shape == ref[k].shape, k
            if np.abs(ref[k]).max() > 0:
                assert _rel(got[k], ref[k]) <= 1e-10, k
    # loaded back on 4 ranks and saved again: the same file
    assert all(out["loaded_equal"] for out in ranks)
    with np.load(tmp_path / "ck.npz") as a, np.load(tmp_path / "ck2.npz") as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], k)
    # and into an unsharded equation
    one = cfg.sharding_box(st, nx=NX, device="cpu")
    st.load_checkpoint(str(tmp_path / "ck.npz"), one)
    np.testing.assert_array_equal(cfg.as_np(one.sig_v), ranks[0]["sig"])
    np.testing.assert_array_equal(cfg.as_np(one.u), ranks[0]["u"])


def test_shard_equation_psum():
    D = W = 4
    ranks, ((_, u, sig, rows), ref) = _run_beside(
        lambda: (_stacked_steps("psum", 3, D), _jax_steps("psum", 3, D)),
        worker.sharded_steps, W, "psum", 3, D, False)
    _held(ranks, u, sig, rows)
    _held(ranks, *ref)


@pytest.mark.parametrize("mode", ["halo", "psum"])
def test_shard_equation_fp32_sweep(mode):
    D = W = 4
    ranks, ((eq, u, sig, rows), ref) = _run_beside(
        lambda: (_stacked_steps(mode, 3, D, True),
                 _jax_steps(mode, 3, D, True)),
        worker.sharded_steps, W, mode, 3, D, True)
    assert eq.fp32_accepted > 0
    assert all(out["fp32_accepted"] == eq.fp32_accepted for out in ranks)
    _held(ranks, u, sig, rows, tol=1e-8)
    _held(ranks, *ref, tol=1e-8)


def test_shard_tm_two_ranks():
    D, W = 4, 2
    def stacked():
        eq, heat = cfg.tm_cube(st, "cpu")
        shard_tm(eq, heat, make_device_mesh(D, device="cpu"))
        cfg.tm_init(eq, heat)
        return eq, heat, eq.solve_tm_time_steps(
            heat, [cfg.HOUR, 2 * cfg.HOUR], [cfg.HOUR] * 2, tol=1e-6,
            maxiter=20)

    ranks, (eq, heat, rows) = _run_beside(stacked, worker.tm_steps, W, D)
    assert (rows[:, 5] == 1).all()
    sig = st.utils.unpad_elems(eq, eq.sig_v)
    for out in ranks:
        np.testing.assert_array_equal(out["rows"][:, [0, 2, 5]],
                                      rows[:, [0, 2, 5]])
        np.testing.assert_array_equal(out["T"], ranks[0]["T"])
        assert _rel(out["T"], cfg.as_np(heat.T)) <= 1e-10
        assert _rel(out["u"], cfg.as_np(eq.u)) <= 1e-10
        assert _rel(out["sig"], sig) <= 1e-10


def test_guards():
    comm = dist.Comm(0, 2, "cpu")     # no group: only the mesh is made
    with pytest.raises(ValueError, match="multiple of 2"):
        make_device_mesh(3, comm=comm)
    mesh = make_device_mesh(comm=comm)
    assert (mesh.n_parts, mesh.world, mesh.parts_per_rank) == (2, 2, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            dist.init_parts(rank=0, world=1)
    assert dist.current() is None


@pytest.mark.parametrize("case", ["group_timeout", "launch_timeout"])
def test_a_hang_fails(case):
    t0 = time.monotonic()
    if case == "group_timeout":
        # rank 0's all-reduce raises after 2 s; launch stops rank 1
        with pytest.raises(Exception):
            _run(worker.skip_collective, 2, timeout=60, group_timeout=2)
    else:
        with pytest.raises(TimeoutError):
            _run(worker.sleep, 2, 60, timeout=5)
    assert time.monotonic() - t0 < 40
