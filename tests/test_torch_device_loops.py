"""The Krylov loops with device-side stopping tests, in blocks.

``safeincave_torch.fem.solvers`` tests its stopping conditions on the device
and advances ``BLOCK`` iterations per host read; an iteration whose test is
false changes nothing.  Held here, on the CPU:

* against a loop that tests on the host after every iteration (the port's
  loops before the blocks, kept below as the reference): the same iterates,
  counts and residuals bit for bit, for block sizes 1, 2, 3, 8 and more than
  the iterations, including ``maxiter`` reached inside a block, a BiCGStab
  breakdown inside a block (a nilpotent shift operator breaks down at
  iteration 10) and a non-finite right-hand side;
* the host reads per solve, counted by patching the tensor's read methods:
  at most ceil(k / B) + 2 for CG and BiCGStab.  ``ir_solve`` reads once per
  block and a defect-correction pass ends with its block, so its reads are
  the sum over passes of ceil(k_pass / B); that is within ceil(k / B) + 2
  while a solve takes at most three passes, as these do;
* against the JAX solvers on tests/test_torch_solvers.py's band-ordered box:
  equal counts, x within 1e-12 relative, for the f64 CG and BiCGStab at
  rtol 1e-12 (at looser targets the iterate is not converged and each
  package's summation order shows, as test_torch_solvers.py explains), and
  for ``ir_solve`` with the CG inner solve at inner_rtol 1e-3 (its f32 inner
  dot products sum in another order in each package; the BiCGStab inner
  counts can differ by a few iterations, which test_torch_solvers.py holds
  within 10%);
* a time step run normally and inside ``graphs.eager()`` gives the same
  bits on the CPU, and reads the host once per fixed-point iteration
  besides its linear solves.
"""
import contextlib
import math

import numpy as np
import pytest
import torch

import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_tpu.fem import solvers as jsol
from safeincave_torch.fem import graphs
from safeincave_torch.fem import solvers as psol
from safeincave_torch.mesh.reorder import reordered_grid
from test_torch_solvers import _ops, problem  # noqa: F401  (fixture)

torch.set_num_threads(1)

BLOCKS = (1, 2, 3, 8, 1000)


# -- the reference: the host loops the blocks replace ------------------------ #
def _nonzero(x):
    return torch.where(x != 0, x, torch.ones_like(x))


def ref_cg(A, b, x0, M_inv, rtol=1e-12, atol=0.0, maxiter=200,
           dot=psol._vdot):
    b_norm = torch.sqrt(dot(b, b))
    tol2 = float(torch.clamp(rtol * b_norm, min=atol) ** 2)
    x, r = x0, b - A(x0)
    z = M_inv(r)
    p, rz, k = z, dot(r, z), 0
    rr = float(dot(r, r))
    while rr > tol2 and k < maxiter and math.isfinite(rr):
        Ap = A(p)
        alpha = rz / _nonzero(dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = dot(r, z)
        p = z + (rz_new / _nonzero(rz)) * p
        rz, k = rz_new, k + 1
        rr = float(dot(r, r))
    return x, k, torch.sqrt(dot(r, r))


def ref_bicgstab(A, b, x0, M_inv, rtol=1e-12, atol=0.0, maxiter=200,
                 dot=psol._vdot):
    b_norm = torch.sqrt(dot(b, b))
    tol2 = float(torch.clamp(rtol * b_norm, min=atol) ** 2)
    eps = torch.finfo(b.dtype).eps
    x, r = x0, b - A(x0)
    rhat, p, v = r, torch.zeros_like(b), torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype)
    rho = alpha = omega = one
    k, broke = 0, False
    rr_t = dot(r, r)
    rr = float(rr_t)
    while rr > tol2 and k < maxiter and not broke and math.isfinite(rr):
        rho_new = dot(rhat, r)
        broke_t = rho_new.abs() < eps * eps * rr_t
        beta = (rho_new / _nonzero(rho)) * (alpha / _nonzero(omega))
        p = r + beta * (p - omega * v)
        phat = M_inv(p)
        v = A(phat)
        alpha = rho_new / _nonzero(dot(rhat, v))
        s = r - alpha * v
        shat = M_inv(s)
        t = A(shat)
        tt = dot(t, t)
        broke_t = broke_t | (tt == 0)
        omega = dot(t, s) / _nonzero(tt)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho, k = rho_new, k + 1
        rr_t = dot(r, r)
        rr, broke = torch.stack([rr_t, broke_t.to(rr_t.dtype)]).tolist()
    return x, k, torch.sqrt(dot(r, r))


def ref_ir(A_hi, A_lo, b, x0, M_inv_lo, inner_solve, rtol=1e-12, atol=0.0,
           inner_rtol=3e-5, inner_maxiter=300, max_passes=12):
    b_norm = torch.sqrt(psol._vdot(b, b))
    tol = float(torch.clamp(rtol * b_norm, min=atol))
    x, r = x0, b - A_hi(x0)
    rnorm_t = torch.sqrt(psol._vdot(r, r))
    rnorm, rnorm_prev, k_tot, passes = float(rnorm_t), math.inf, 0, 0
    while (rnorm > tol and passes < max_passes and rnorm < 0.5 * rnorm_prev
           and math.isfinite(rnorm)):
        scale = rnorm_t if rnorm > 0 else torch.ones_like(rnorm_t)
        rhs = (r / scale).to(torch.float32)
        d, k, _ = inner_solve(A_lo, rhs, torch.zeros_like(rhs), M_inv_lo,
                              rtol=inner_rtol, maxiter=inner_maxiter)
        x_try = x
        if math.isfinite(float(psol._vdot(d, d))):
            x_try = x + scale * d.to(b.dtype)
        r_try = b - A_hi(x_try)
        rn_try_t = torch.sqrt(psol._vdot(r_try, r_try))
        rn_try = float(rn_try_t)
        rnorm_prev = rnorm
        if math.isfinite(rn_try) and rn_try < rnorm:
            x, r, rnorm_t, rnorm = x_try, r_try, rn_try_t, rn_try
        k_tot, passes = k_tot + k, passes + 1
    return x, k_tot, rnorm_t


REFS = {"cg": ref_cg, "bicgstab": ref_bicgstab}


# -- helpers ----------------------------------------------------------------- #
class Reads:
    """Counts the host reads of tensors while active."""
    NAMES = ("item", "tolist", "__float__", "__bool__", "__int__")

    def __enter__(self):
        self.n = 0
        self.saved = {k: getattr(torch.Tensor, k) for k in self.NAMES}
        for k, f in self.saved.items():
            setattr(torch.Tensor, k, self._counted(f))
        return self

    def _counted(self, f):
        def read(t, *a, **kw):
            self.n += 1
            return f(t, *a, **kw)
        return read

    def __exit__(self, *exc):
        for k, f in self.saved.items():
            setattr(torch.Tensor, k, f)


@pytest.fixture
def block(monkeypatch):
    def set_block(n):
        monkeypatch.setattr(psol, "BLOCK", n)
    return set_block


def same_bits(got, want):
    (xg, kg, rg), (xw, kw, rw) = got, want
    assert kg == kw
    assert torch.equal(xg, xw)
    assert torch.equal(rg, rw) or (rg.isnan() and rw.isnan())


def shift(n=12):
    """A nilpotent shift operator and e_0: BiCGStab breaks down (t = 0)
    at iteration 10."""
    S = torch.diag(torch.ones(n - 1, dtype=torch.float64), -1)
    b = torch.zeros(n, dtype=torch.float64)
    b[0] = 1.0
    return (lambda x: S @ x), b


# -- bit for bit against the host loop, for every block size ----------------- #
@pytest.mark.parametrize("B", BLOCKS)
@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_blocked_krylov_is_the_host_loop(problem, block, method, B):
    A, _, M, arr = _ops(problem, "port")
    b = arr(problem["b"])
    want = REFS[method](A, b, b * 0.0, M, rtol=1e-12, maxiter=500)
    block(B)
    with Reads() as reads:
        got = getattr(psol, f"{method}_solve")(A, b, b * 0.0, M, rtol=1e-12,
                                               maxiter=500)
    same_bits(got, want)
    assert 0 < got[1] < 500
    assert reads.n <= math.ceil(got[1] / B) + 2


@pytest.mark.parametrize("B", (2, 3, 8))
@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_maxiter_inside_a_block(problem, block, method, B):
    A, _, M, arr = _ops(problem, "port")
    b = arr(problem["b"])
    want = REFS[method](A, b, b * 0.0, M, rtol=1e-12, maxiter=5)
    block(B)
    with Reads() as reads:
        got = getattr(psol, f"{method}_solve")(A, b, b * 0.0, M, rtol=1e-12,
                                               maxiter=5)
    same_bits(got, want)
    assert got[1] == 5
    assert reads.n <= math.ceil(5 / B) + 2


@pytest.mark.parametrize("B", BLOCKS)
def test_bicgstab_breakdown_inside_a_block(block, B):
    A, b = shift()
    M = lambda r: r  # noqa: E731
    want = ref_bicgstab(A, b, b * 0.0, M, rtol=1e-12, maxiter=200)
    assert want[1] == 10 and math.isfinite(float(want[2]))
    block(B)
    with Reads() as reads:
        got = psol.bicgstab_solve(A, b, b * 0.0, M, rtol=1e-12, maxiter=200)
    same_bits(got, want)
    assert reads.n <= math.ceil(10 / B) + 2


@pytest.mark.parametrize("B", (1, 3, 1000))
@pytest.mark.parametrize("method", ["cg", "bicgstab", "ir"])
def test_non_finite_rhs_stops_at_once(problem, block, method, B):
    A, A_lo, M, arr = _ops(problem, "port")
    b = arr(problem["b"]).clone()
    b[3, 1] = float("nan")
    x0 = arr(np.ones_like(problem["b"]))
    block(B)
    with Reads() as reads:
        if method == "ir":
            x, k, res = psol.ir_solve(A, A_lo, b, x0, M, rtol=1e-12)
        else:
            x, k, res = getattr(psol, f"{method}_solve")(A, b, x0, M)
    assert k == 0 and torch.equal(x, x0) and res.isnan()
    assert reads.n == 1


# -- ir_solve: bit for bit, reads, and inside-a-block limits ---------------- #
@pytest.mark.parametrize("B", BLOCKS)
@pytest.mark.parametrize("inner", ["cg", "bicgstab"])
def test_blocked_ir_solve_is_the_host_loop(problem, block, inner, B):
    A_hi, A_lo, M, arr = _ops(problem, "port")
    b = arr(problem["b"])
    kw = dict(rtol=1e-12, inner_rtol=1e-4, inner_maxiter=400, max_passes=12)
    want = ref_ir(A_hi, A_lo, b, b * 0.0, M, REFS[inner], **kw)
    block(B)
    with Reads() as reads:
        got = psol.ir_solve(A_hi, A_lo, b, b * 0.0, M,
                            inner_solve=getattr(psol, f"{inner}_solve"), **kw)
    same_bits(got, want)
    assert float(got[2]) <= 1e-12 * np.linalg.norm(problem["b"])
    assert reads.n <= math.ceil(got[1] / B) + 2


@pytest.mark.parametrize("B", (2, 3, 8))
def test_ir_inner_maxiter_inside_a_block(problem, block, B):
    A_hi, A_lo, M, arr = _ops(problem, "port")
    b = arr(problem["b"])
    kw = dict(rtol=1e-12, inner_rtol=1e-4, inner_maxiter=5, max_passes=6)
    want = ref_ir(A_hi, A_lo, b, b * 0.0, M, ref_bicgstab, **kw)
    block(B)
    got = psol.ir_solve(A_hi, A_lo, b, b * 0.0, M, **kw)
    same_bits(got, want)
    assert got[1] % 5 == 0 and got[1] > 0


# -- against the JAX solvers ------------------------------------------------- #
@pytest.mark.parametrize("B", (1, 8))
@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_f64_krylov_matches_jax(problem, block, method, B):
    block(B)
    out = {}
    for pkg, mod in (("port", psol), ("jax", jsol)):
        A, _, M, arr = _ops(problem, pkg)
        b = arr(problem["b"])
        x, k, _ = getattr(mod, f"{method}_solve")(A, b, b * 0.0, M,
                                                  rtol=1e-12, maxiter=500)
        out[pkg] = (np.asarray(x), int(k))
    (xp, kp), (xj, kj) = out["port"], out["jax"]
    assert kp == kj and 0 < kp < 500
    np.testing.assert_allclose(xp, xj, rtol=0, atol=1e-12 * np.abs(xj).max())


@pytest.mark.parametrize("B", (1, 8))
def test_ir_solve_matches_jax(problem, block, B):
    block(B)
    kw = dict(rtol=1e-12, inner_rtol=1e-3, inner_maxiter=400, max_passes=12)
    out = {}
    for pkg, mod in (("port", psol), ("jax", jsol)):
        A_hi, A_lo, M, arr = _ops(problem, pkg)
        b = arr(problem["b"])
        x, k, _ = mod.ir_solve(A_hi, A_lo, b, b * 0.0, M,
                               inner_solve=mod.cg_solve, **kw)
        out[pkg] = (np.asarray(x), int(k))
    (xp, kp), (xj, kj) = out["port"], out["jax"]
    assert kp == kj
    np.testing.assert_allclose(xp, xj, rtol=0, atol=1e-12 * np.abs(xj).max())


# -- graphs.eager() and the time step on the CPU ----------------------------- #
def test_graphs_call_directly_on_the_cpu():
    g = graphs.Graphs("cpu")
    x = torch.arange(6.0)

    def fn(a, d):
        return {"y": a * 2, "same": d["k"]}, a

    plain = g(("k", 1.0), fn, x, {"k": x})
    with graphs.eager():
        inside = g(("k", 1.0), fn, x, {"k": x})
    assert not g.live and g.replays == 0
    for out in (plain, inside):
        assert torch.equal(out[0]["y"], x * 2)
        assert out[0]["same"] is x and out[1] is x
    stepped = g.step("s", lambda s: ((s[0] + 1,), s[0].sum()), (x,))
    assert torch.equal(stepped[0][0], x + 1) and float(stepped[1]) == 15.0


def _small_equation(fp32):
    box = st.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=3, ny=3, nz=3)
    grid = reordered_grid(box, method="band")[0]
    eq = cfg.wire_bench(st, grid, precond="dense" if fp32 else "2level",
                        fp32_phase=fp32, device="cpu")
    eq.enable_band_matvec()
    cfg.elastic_init(eq)
    return eq


def _fields(eq, rows):
    return [torch.as_tensor(rows), eq.u, eq.sig_v, eq.eps_tot_v] + [
        v for e in eq.mat.elems_ne for v in e.state.values()]


@pytest.mark.parametrize("fp32", [False, True])
def test_eager_is_the_plain_call_on_the_cpu(fp32):
    out = []
    for use_eager in (False, True):
        eq = _small_equation(fp32)
        ctx = graphs.eager() if use_eager else contextlib.nullcontext()
        with ctx:
            rows = eq.solve_time_steps([cfg.HOUR, 2 * cfg.HOUR],
                                       [cfg.HOUR] * 2, tol=1e-8, maxiter=40)
        assert (rows[:, 5] == 1).all()
        out.append(_fields(eq, rows))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_one_read_per_fixed_point_iteration_besides_the_solves():
    eq = _small_equation(False)
    solve_lin = eq._get_solver()
    inside = [0]

    def counted_solve(*args):
        before = reads.n
        out = solve_lin(*args)
        inside[0] += reads.n - before
        return out

    eq._solve_lin = counted_solve
    with Reads() as reads:
        rows = eq.solve_time_steps([cfg.HOUR, 2 * cfg.HOUR], [cfg.HOUR] * 2,
                                   tol=1e-8, maxiter=40)
    assert (rows[:, 5] == 1).all()
    assert reads.n - inside[0] == rows[:, 0].sum()
