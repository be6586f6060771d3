"""The CUDA kernels of safeincave_torch on the card, at the shapes that
chip_smoke.py measures: the band kernel at cavern_proxy_600 (the main path),
at the band-ordered GridBox nx=44 (bench.py's scale size) and at the
band-ordered 38k-tet cavern_interlayer_1200 (the yearly path), the block-DIA
kernel at nx=17 (the box path) and nx=44 in f32, and at nx=17 in f64.

Each kernel against its plain twin on a random energy-symmetric tangent
(band 2e-5 max|ref|, DIA f32 1e-5 and f64 1e-12: the sums run in another
order), bitwise repeatable, energy-symmetric (v.Au = u.Av), one counted
launch per call, and a refusal of a tensor it cannot take.

The band kernel's f64 action (``operator64``) at the same three shapes
against its plain twin in f64 (1e-13 max|ref|), with the same checks,
counted apart from the f32 launches; and the linear solve of one fixed-point
iteration with it, captured against eager and against the cumsum f64 action
(fields within 1e-10, Krylov counts within 2).

The dense preconditioner's packed symmetric apply at cavern_proxy_600's and
cavern_interlayer_1200's 3N (10,080 and 23,007) on a random inverse, against
its plain twin (1e-5 max|ref|), with the same checks.

The captured graphs of one fixed-point iteration on the cavern600 main path
(phase 4's equation: band kernel, dense preconditioner): the tangent suite,
the Krylov blocks of a linear solve and the update, each captured, then
replayed under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in
a replay raises), and held bit for bit against the same function under
``graphs.eager()``; every call is one replay, and the band kernel's and the
preconditioner's counters count the launches of the replayed blocks as the
eager solve counts its own.

A capture runs with the garbage collector off and turns it back on: a
collection inside it could destroy another equation's graphs, which a
capture forbids.

The file imports no JAX, so it runs on the machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: tests/conftest.py sets JAX up for the rest of the
suite.)  Without a CUDA device every test skips.
"""
import gc

import numpy as np
import pytest
import torch

import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_torch.fem import graphs
from safeincave_torch.fem.bandkernel import BandMatvec, band_matvec_plain
from safeincave_torch.fem.dia import BlockDIA, dia_matvec_plain
from safeincave_torch.fem.kernels import MomentumKernel
from safeincave_torch.fem.symdense import (B, SymDense, chunk_index,
                                           n_chunks, sym_dense_plain)
from safeincave_torch.mesh.reorder import reordered_grid
from safeincave_torch.utils import voigt_weight


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU, see the module "
                    "docstring)")
    return torch.device("cuda")


def _box(nx):
    return st.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=nx, ny=nx, nz=nx)


def _random_ct(E, rng, dtype, device):
    """Random energy-symmetric tangent (6, 6, E): A is then symmetric."""
    M = rng.normal(size=(E, 6, 6))
    CT = 0.5 * (M + np.transpose(M, (0, 2, 1))) + 8.0 * np.eye(6)
    w = np.diag([1.0, 1, 1, 2, 2, 2])
    CT = 0.5 * (CT + np.linalg.inv(w) @ np.transpose(CT, (0, 2, 1)) @ w)
    return torch.as_tensor(np.transpose(CT, (1, 2, 0)), dtype=dtype,
                           device=device)


def _hold(op, counter, plain, u, v, tol, sym_tol, count="launches"):
    """op (a wrapper's operator) against ``plain`` on u: max|err| within
    tol max|ref|, bitwise repeatable, v.Au = u.Av, 3 launches counted in
    ``counter``'s attribute ``count``."""
    n0 = getattr(counter, count)
    got, again, Av = op(u), op(u), op(v)
    torch.cuda.synchronize()
    assert getattr(counter, count) == n0 + 3
    ref = plain(u)
    assert torch.equal(got, again)
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    a = (v.double() * got.double()).sum().item()
    b = (u.double() * Av.double()).sum().item()
    assert abs(a - b) <= sym_tol * abs(a)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["cavern600", "box44_band", "cavern1200"])
def test_band_kernel(cuda, shape):
    grid = {"cavern600": lambda: cfg.cavern600_grid(st),
            "box44_band": lambda: reordered_grid(_box(44), "band")[0],
            "cavern1200": lambda: cfg.yearly_grid(st)}[shape]()
    rng = np.random.default_rng(0)
    band = BandMatvec(MomentumKernel(grid, cuda))
    ctv = band.pack_ct(_random_ct(grid.n_elems, rng, torch.float32, cuda))
    u, v = (torch.as_tensor(rng.normal(size=(grid.n_nodes, 3)),
                            dtype=torch.float32, device=cuda)
            for _ in range(2))
    op = band.operator(ctv)
    _hold(op, band, lambda x: band_matvec_plain(ctv, band.gN, band.conn,
                                                band.plan, x),
          u, v, 2e-5, 1e-5)
    with pytest.raises(ValueError):
        band.operator(ctv.double())
    with pytest.raises(ValueError):
        op(u.double())
    with pytest.raises(ValueError):
        op(u.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["cavern600", "box44_band", "cavern1200"])
def test_band_kernel_f64(cuda, shape):
    """The f64 action (``operator64``) against the plain twin in f64 at
    1e-13 max|ref| (the sums run in another order), bitwise repeatable,
    v.Au = u.Av at 1e-12, counted in ``launches64`` and not in
    ``launches``; f32 and CPU tensors refused."""
    grid = {"cavern600": lambda: cfg.cavern600_grid(st),
            "box44_band": lambda: reordered_grid(_box(44), "band")[0],
            "cavern1200": lambda: cfg.yearly_grid(st)}[shape]()
    rng = np.random.default_rng(0)
    band = BandMatvec(MomentumKernel(grid, cuda))
    ctv = band.pack_ct64(_random_ct(grid.n_elems, rng, torch.float64, cuda))
    u, v = (torch.as_tensor(rng.normal(size=(grid.n_nodes, 3)),
                            dtype=torch.float64, device=cuda)
            for _ in range(2))
    op = band.operator64(ctv)
    n32 = band.launches
    _hold(op, band, lambda x: band_matvec_plain(ctv, band.gN64, band.conn,
                                                band.plan, x),
          u, v, 1e-13, 1e-12, count="launches64")
    assert band.launches == n32
    with pytest.raises(ValueError):
        band.operator64(ctv.float())
    with pytest.raises(ValueError):
        op(u.float())
    with pytest.raises(ValueError):
        op(u.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("nx,dtype,tol", [(17, torch.float32, 1e-5),
                                          (44, torch.float32, 1e-5),
                                          (17, torch.float64, 1e-12)])
def test_dia_kernel(cuda, nx, dtype, tol):
    g = _box(nx)
    rng = np.random.default_rng(1)
    dia = BlockDIA(MomentumKernel(g, cuda))
    assert dia.structured and dia.ld % 4 == 0
    vals = dia.assemble(_random_ct(g.n_elems, rng, dtype, cuda))
    assert not vals[:, g.n_nodes:].any()
    u, v = (torch.as_tensor(rng.normal(size=(g.n_nodes, 3)), dtype=dtype,
                            device=cuda) for _ in range(2))
    op = dia.operator(vals)
    _hold(op, dia, lambda x: dia_matvec_plain(vals, x, dia.offsets,
                                              g.n_nodes),
          u, v, tol, 1e-5 if dtype == torch.float32 else 1e-12)
    other = torch.float64 if dtype == torch.float32 else torch.float32
    with pytest.raises(ValueError):
        op(u.to(other))
    with pytest.raises(ValueError):
        dia.operator(vals[:, 1:])                  # not the padded layout


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["cavern600", "cavern1200"])
def test_sym_dense_kernel(cuda, shape):
    """The dense preconditioner's apply at the main paths' sizes (3N =
    10,080 and 23,007) on a random inverse, packed symmetrized."""
    grid = {"cavern600": lambda: cfg.cavern600_grid(st),
            "cavern1200": lambda: cfg.yearly_grid(st)}[shape]()
    n = 3 * grid.n_nodes
    g = torch.Generator(device=cuda).manual_seed(n)
    sym = SymDense(torch.randn((n, n), generator=g, device=cuda))
    assert sym.tiles.shape == (n_chunks(n), B, 32)
    u, v = (torch.randn(n, generator=g, device=cuda) for _ in range(2))
    index = tuple(torch.as_tensor(a, device=cuda) for a in chunk_index(n))
    _hold(sym, sym, lambda x: sym_dense_plain(sym.tiles, n, x, index),
          u, v, 1e-5, 1e-5)
    for bad in (u.double(), u[:-1], u.reshape(-1, 3), u.cpu(), u[::2]):
        with pytest.raises(ValueError):
            sym(bad)


# -- the captured graphs of a fixed-point iteration at cavern600 ------------- #
@pytest.fixture(scope="module")
def cavern600():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU, see the module "
                    "docstring)")
    eq = cfg.wire_bench(st, cfg.cavern600_grid(st), precond="auto",
                        device="cuda")
    cfg.elastic_init(eq)
    return eq


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _same(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w)
        else:
            assert g == w


def _strict(eq, call):
    """``call()`` (a replay) with host syncs raising; one replay more."""
    n = eq.graphs.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert eq.graphs.replays == n + 1
    return out


def _iteration(eq):
    """The arguments of one fixed-point iteration's pieces."""
    b_ext, mask, u_bc = eq._step_inputs(cfg.HOUR)
    states = [e.state for e in eq.mat.elems_ne]
    sv = eq.sig_v
    tangent = (states, sv, eq.Temp, cfg.HOUR)
    new_states, G_p, CT, B6 = eq._tangent(*tangent)
    states2, eps_rhs, b, x0 = eq._rhs(new_states, G_p, B6, CT, sv, None,
                                      b_ext, eq.u, mask, u_bc, cfg.HOUR)
    return dict(tangent=tangent, CT=CT, b=b, mask=mask, u_bc=u_bc, x0=x0,
                eps_rhs=eps_rhs, states2=states2, sv=sv)


@pytest.mark.gpu
def test_capture_runs_without_the_collector(cuda):
    seen = []

    def plus_one(v):
        seen.append(gc.isenabled())
        return v + 1
    x = torch.arange(8.0, device=cuda)
    out = graphs.Graphs(cuda)(("plus_one",), plus_one, x)
    assert seen == [True, False] and gc.isenabled()   # warm-up, capture
    assert torch.equal(out, x + 1)


@pytest.mark.gpu
def test_tangent_suite_graph(cavern600):
    eq = cavern600
    args = _iteration(eq)["tangent"]
    with graphs.eager():
        want = eq._tangent(*args)
    _same(eq._tangent(*args), want)
    _same(_strict(eq, lambda: eq._tangent(*args)), want)


@pytest.mark.gpu
def test_krylov_block_graph(cavern600):
    eq = cavern600
    it = _iteration(eq)
    P, _ = eq._get_precond()
    band, sym = eq.kernel.band, eq._sym_dense()
    assert sym is P[0]

    def solve():
        n = band.launches, sym.launches
        x, k, res, bnorm = eq._get_solver()(it["CT"], it["b"], it["mask"],
                                            it["u_bc"], it["x0"], 1e-12, P)
        torch.cuda.synchronize()
        return (x, k, res, bnorm), (band.launches - n[0],
                                    sym.launches - n[1])

    with graphs.eager():
        want, launches = solve()
    assert want[1] > 0 and min(launches) > 0
    got, n_first = solve()                  # captures, then replays
    _same(got, want)
    assert n_first == launches
    step = eq.graphs.step
    replays = [0]

    def strict_step(*a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return step(*a)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            replays[0] += 1

    eq.graphs.step = strict_step
    try:
        n = eq.graphs.replays
        got, n_replayed = solve()
    finally:
        del eq.graphs.step
    _same(got, want)
    assert n_replayed == launches
    assert eq.graphs.replays - n == replays[0] > 0


@pytest.mark.gpu
def test_f64_band_action_solve(cavern600, monkeypatch):
    """The linear solve of one fixed-point iteration with its f64 action on
    the band kernel: captured as eager, bit for bit, with the same f64
    launches; against the same solve with the cumsum f64 action, fields
    within 1e-10 max|x| and Krylov counts within 2."""
    from safeincave_torch.fem import momentum
    eq = cavern600
    it = _iteration(eq)
    P, _ = eq._get_precond()
    band = eq.kernel.band

    def solve():
        n = band.launches64
        x, k, _, _ = eq._get_solver()(it["CT"], it["b"], it["mask"],
                                      it["u_bc"], it["x0"], 1e-12, P)
        torch.cuda.synchronize()
        return x, k, band.launches64 - n

    with graphs.eager():
        x_e, k_e, n_e = solve()
    x_g, k_g, n_g = solve()
    assert n_e > 0 and (k_g, n_g) == (k_e, n_e)
    assert torch.equal(x_g, x_e)
    monkeypatch.setattr(momentum, "_f64_action", lambda kern, CT: (
        momentum._cumsum_operator(kern), CT, None))
    with graphs.eager():
        x_c, k_c, n_c = solve()
    assert n_c == 0 and abs(k_c - k_e) <= 2
    assert (x_e - x_c).abs().max().item() <= \
        1e-10 * x_c.abs().max().item()


@pytest.mark.gpu
def test_update_graph(cavern600):
    eq = cavern600
    it = _iteration(eq)
    P, _ = eq._get_precond()
    u_new, _, res, bnorm = eq._get_solver()(it["CT"], it["b"], it["mask"],
                                            it["u_bc"], it["x0"], 1e-12, P)
    args = (u_new, it["CT"], it["eps_rhs"], it["states2"], it["sv"], eq.Temp,
            eq.eps_tot_v, voigt_weight(it["sv"]), res, bnorm, cfg.HOUR)
    with graphs.eager():
        want = eq._update(*args)
    _same(eq._update(*args), want)
    got = _strict(eq, lambda: eq._update(*args))
    _same(got, want)
    assert got[0] is u_new                  # an input passed through
    assert torch.isfinite(got[4]).all()


# -- the tracer's run records on the card ------------------------------------ #
def _events_around(eq):
    """CUDA events recorded around every call of ``eq``'s tangent suite and
    linear solves (the f64 solve and the f32 sweep's), from outside the
    equation; returns ({kind: [(start, stop)]}, undo)."""
    spans = {"tangent": [], "solve": []}

    def timed(kind, fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            stop.record()
            spans[kind].append((start, stop))
            return out
        return call

    solvers = (eq._get_solver(), eq._get_solve32())
    eq._tangent = timed("tangent", eq._tangent)
    eq._solve_lin = timed("solve", solvers[0])
    eq._solve32 = timed("solve", solvers[1])

    def undo():
        del eq._tangent
        eq._solve_lin, eq._solve32 = solvers
    return spans, undo


@pytest.mark.gpu
def test_second_run_captures_nothing_and_device_spans_agree(cuda, tmp_path):
    """Two Simulator_M runs of three fused 1 h steps from one saved state
    (cavern600, the f32 sweep on): the first captures graphs, the second
    none and lists no capture keys; the second run's device spans agree
    with events recorded around the same calls from outside, replays are
    its replay spans, and its gaps lie inside the run."""
    from safeincave_torch import tracing
    eq = cfg.wire_bench(st, cfg.cavern600_grid(st), precond="auto",
                        fp32_phase="auto", device="cuda")
    cfg.elastic_init(eq)
    state = str(tmp_path / "state.npz")
    st.save_checkpoint(state, eq)

    def run():
        tc = st.TimeController(dt=1.0, initial_time=0.0, final_time=3.0,
                               time_unit="hour")
        st.load_checkpoint(state, eq, tc)
        st.Simulator_M(eq, tc, [], compute_elastic_response=False).run()
        return tracing.runs[-1]

    first = run()
    spans, undo = _events_around(eq)
    try:
        second = run()
    finally:
        undo()
    assert first["counters"]["captures"] > 0 and first["captures"]
    assert second["counters"]["captures"] == 0 and second["captures"] == []
    assert second["steps"] == 3 and second["cuda"]
    assert second["spans"]["replay"]["count"] == \
        second["counters"]["replays"] > 0
    assert 0 < sum(second["gaps"].values()) \
        < second["end_ns"] - second["start_ns"]
    for kind in ("tangent", "solve"):
        ours = [ms for _, ms in second["device"][kind]]
        theirs = [a.elapsed_time(b) for a, b in spans[kind]]
        assert len(ours) == len(theirs) > 0, kind
        for a, b in zip(ours, theirs):
            assert abs(a - b) <= 0.03 * b + 0.05, (kind, a, b)
