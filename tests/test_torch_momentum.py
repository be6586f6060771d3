"""PyTorch port vs JAX package: the cavern mechanics slice as a whole.

The bench's material and loads (tests/torch_port_configs.py) on a
band-reordered box, with ``precond="2level"`` and ``fp32_phase=False`` pinned
on both sides: the elastic response, then 3 steps of ``solve_time_steps`` at
dt = 3600 s.  Fields agree at 1e-8 relative and the per-step
``[iterations, converged]`` rows are equal.

Krylov counts are not required to be equal.  The inner f32 BiCGStab passes
of ``ir_solve`` apply the f32 cumsum matvec, whose prefix sum XLA's CPU
backend evaluates as a parallel scan and torch as a sequential one, so the
f32 iterates differ in the last bits and an inner pass can stop one or two
iterations apart.  The f64 outer criterion is the same, so the fields do
not move beyond the solve tolerance.  Counts must agree within 10%.
"""
import os

import numpy as np
import pytest
import torch

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_tpu.fem.momentum import (
    _dense_inverse_precond as jax_dense_inverse)
from safeincave_tpu.fem.kernels import MomentumKernel as JaxKernel
from safeincave_tpu.mesh.reorder import reordered_grid as jax_reordered
from safeincave_torch.fem.kernels import MomentumKernel
from safeincave_torch.fem.momentum import _dense_inverse_precond
from safeincave_torch.interop import load_numpy_state, numpy_state
from safeincave_torch.mesh.reorder import reordered_grid

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
N_STEPS = 3
DT = cfg.HOUR


def _box(pkg, nx=4):
    reorder = reordered_grid if pkg is st else jax_reordered
    box = pkg.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=nx, ny=nx, nz=nx)
    return reorder(box, method="band")[0]


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=what)


def _to_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _record(eq, rows, out):
    out["rows"] = np.asarray(rows)
    for k in ("u", "sig_v", "eps_tot_v"):
        out[k] = _to_np(getattr(eq, k))
    out["states"] = [{k: _to_np(v) for k, v in e.state.items()}
                     for e in eq.mat.elems_ne]
    return out


def _steps(eq):
    return eq.solve_time_steps([(k + 1) * DT for k in range(N_STEPS)],
                               [DT] * N_STEPS, tol=1e-8, maxiter=40)


@pytest.fixture(scope="module")
def runs():
    """JAX and port from their own elastic solves, and the port continued
    from the JAX package's post-elastic state (interop)."""
    out = {}
    for name, pkg in (("jax", sc), ("port", st)):
        eq = cfg.wire_bench(pkg, _box(pkg), device="cpu")
        cfg.elastic_init(eq)
        r = dict(u_el=_to_np(eq.u), kry_el=eq.solver_stats[0])
        if pkg is sc:
            jax_elastic = numpy_state(eq)
        out[name] = _record(eq, _steps(eq), r)
    eq = cfg.wire_bench(st, _box(st), device="cpu")
    load_numpy_state(eq, jax_elastic)
    out["port_from_jax"] = _record(eq, _steps(eq), {})
    return out


@pytest.mark.parametrize("name", ["port", "port_from_jax"])
def test_slice_fields_match(runs, name):
    j, p = runs["jax"], runs[name]
    if name == "port":
        _close(p["u_el"], j["u_el"], 1e-8, "elastic u")
    for k in ("u", "sig_v", "eps_tot_v"):
        _close(p[k], j[k], 1e-8, k)


@pytest.mark.parametrize("name", ["port", "port_from_jax"])
def test_slice_fixed_point_rows_match(runs, name):
    j, p = runs["jax"]["rows"], runs[name]["rows"]
    assert j.shape == p.shape == (N_STEPS, 6)
    assert (j[:, 5] == 1).all()
    np.testing.assert_array_equal(p[:, [0, 5]], j[:, [0, 5]])


def test_slice_krylov_counts(runs):
    """Deviation allowed and why: module docstring."""
    j, p = runs["jax"], runs["port"]
    assert abs(p["kry_el"] - j["kry_el"]) <= 0.1 * j["kry_el"]
    np.testing.assert_allclose(p["rows"][:, 2], j["rows"][:, 2], rtol=0.1)


def test_slice_internal_variables(runs):
    """Committed internal variables after the 3 steps.  Strains and rates
    are compared on the scale of the mechanism set (a non-yielding Desai
    element holds ~1e-41 of finite-difference noise)."""
    j, p = runs["jax"], runs["port"]
    eps_scale = np.abs(j["eps_tot_v"]).max()
    rate_scale = max(np.abs(s["rate_old"]).max() for s in j["states"])
    for sj, sp in zip(j["states"], p["states"]):
        for k, scale in (("eps_old", eps_scale), ("rate_old", rate_scale),
                         ("alpha", None), ("qsi_old", None)):
            if k in sj:
                atol = 1e-8 * (scale or np.abs(sj[k]).max())
                np.testing.assert_allclose(sp[k], sj[k], rtol=1e-8,
                                           atol=atol, err_msg=k)


@pytest.mark.parametrize("precision,precond", [("f64", "2level"),
                                                ("mixed", "jacobi")])
def test_elastic_solver_paths(precision, precond):
    """The straight-f64 solve and the block-Jacobi preconditioner (off the
    benchmark path) against the JAX package: elastic u at 1e-8, Krylov
    counts within 10% (module docstring)."""
    out = {}
    for name, pkg in (("jax", sc), ("port", st)):
        eq = cfg.wire_bench(pkg, _box(pkg, nx=3), device="cpu")
        eq.set_solver(pkg.SolverSettings(precond=precond, precision=precision,
                                         fp32_phase=False, **cfg.SETTINGS))
        eq.bc.update_dirichlet(0.0)
        eq.bc.update_neumann(0.0)
        eq.solve_elastic_response()
        out[name] = (_to_np(eq.u), eq.solver_stats[0])
    _close(out["port"][0], out["jax"][0], 1e-8, "elastic u")
    assert abs(out["port"][1] - out["jax"][1]) <= 0.1 * out["jax"][1]


def test_band_wired_solver_matches_default():
    """enable_band_matvec: the band operator (its plain twin on the CPU) as
    the f32 Krylov operator reproduces the default cumsum path; the f64
    defect correction pins the converged solution."""
    def run(band):
        eq = cfg.wire_bench(st, _box(st, nx=3), device="cpu")
        if band:
            eq.enable_band_matvec()
        cfg.elastic_init(eq)
        rows = eq.solve_time_steps([DT, 2 * DT], [DT] * 2, tol=1e-8,
                                   maxiter=40)
        assert (rows[:, 5] == 1).all()
        return eq.u.numpy(), eq.kernel.band
    u_ref, _ = run(False)
    u_band, band = run(True)
    assert band is not None and band.launches == 0   # CPU: plain twin
    np.testing.assert_allclose(u_band, u_ref, rtol=0,
                               atol=1e-9 * np.abs(u_ref).max())


# -- golden triaxial (tests/golden_configs.py twin, port API) --------------- #
def _build_triaxial_port(nx=3):
    grid = st.GridBox(nx=nx, ny=nx, nz=nx)
    eq = st.LinearMomentum(grid, theta=0.5, device="cpu")
    eq.set_solver(st.SolverSettings(method="bicgstab", rtol=1e-12,
                                    max_it=500))
    n = eq.n_elems
    eq.set_material(cfg.bench_material(st, n, "cpu"))
    eq.set_T0(298.0 * np.ones(n))
    eq.set_T(298.0 * np.ones(n))
    eq.build_body_force([0.0, 0.0, 0.0])
    momBC = st.MomentumBC
    bc = momBC.BcHandler(eq)
    tv = [0.0, 1e9]
    for nm, comp in (("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2)):
        bc.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.], tv))
    for nm in ("EAST", "NORTH"):
        bc.add_boundary_condition(momBC.NeumannBC(
            nm, 2, 0.0, 0.0, [4 * cfg.MPa, 4 * cfg.MPa], tv, g=0.0))
    bc.add_boundary_condition(momBC.NeumannBC(
        "TOP", 2, 0.0, 0.0, [8 * cfg.MPa, 8 * cfg.MPa], tv, g=0.0))
    eq.set_boundary_conditions(bc)
    return eq


def test_golden_triaxial():
    u, sv, rows = cfg.run_sharding_steps(_build_triaxial_port(), n_steps=3)
    assert (rows[:, 1] <= 1e-8).all(), rows
    with np.load(os.path.join(HERE, "golden", "fields.npz")) as z:
        _close(u, z["triaxial_u"], 1e-8, "triaxial_u")
        _close(sv, z["triaxial_sig"], 1e-8, "triaxial_sig")


def test_dense_preconditioner_matches_jax():
    """The dense f32 inverse of the masked elastic operator.  JAX sums the
    element blocks in f32, the port in f64 before the cast, and the two f32
    inversions round differently, so the applied inverses agree to the f32
    conditioning of the operator, not bitwise."""
    g_p, g_j = _box(st, nx=2), _box(sc, nx=2)
    E, N = g_p.n_elems, g_p.n_nodes
    C = cfg.bench_material(st, E, "cpu").C.numpy()
    mask = np.ones((N, 3))
    nodes = np.unique(g_p.tris[g_p.get_boundary_tags("BOTTOM")])
    mask[nodes] = 0.0
    inv_p = _dense_inverse_precond(MomentumKernel(g_p, "cpu"), C, mask)
    inv_j = np.asarray(jax_dense_inverse(JaxKernel(g_j), C, mask))
    r = np.random.default_rng(0).normal(size=3 * N).astype(np.float32)
    zp = inv_p.numpy() @ r
    zj = inv_j @ r
    np.testing.assert_allclose(zp, zj, rtol=0, atol=1e-4 * np.abs(zj).max())


def test_fp32_phase_auto_resolves_by_device():
    """The f32 phase's "auto" resolves by the equation's device, as the JAX
    package's does by backend, and True forces it anywhere.  The solver
    options construct with the JAX package's defaults (tangent lagging,
    adaptive tolerances and the bf16 preconditioner off); their behaviour
    is held in tests/test_torch_lag.py and test_torch_equation_api.py."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    auto = st.SolverSettings(fp32_switch=1e-4)
    assert auto.fp32_enabled(cpu) is False and auto.fp32_enabled(cuda)
    assert st.SolverSettings(fp32_phase=True).fp32_enabled(cpu)
    assert not st.SolverSettings(fp32_phase=False).fp32_enabled(cuda)
    for name in ("lag_tangent", "adaptive_rtol", "precond_bf16"):
        assert getattr(auto, name) is False
        assert getattr(auto, name) == getattr(sc.SolverSettings(), name)
        assert getattr(st.SolverSettings(**{name: True}), name) is True


# -- the f32 fixed-point sweep ---------------------------------------------- #
# At dt = 60 s the sweep contracts to the switch and the gate accepts it in
# every step; at the bench's 1 h steps on a coarse box the Kelvin-Voigt
# strain jumps so far per step that the sweep stops on the "halve the error"
# test and the gate discards it, in both packages alike.
FP32_DT = 60.0


@pytest.fixture(scope="module")
def fp32_runs():
    """The bench's material and loads on a natural-order box with
    enable_dia_matvec: JAX and the port with fp32_phase=True, and the port
    with the phase off."""
    out = {}
    for name, pkg, fp32 in (("jax", sc, True), ("port", st, True),
                            ("port_f64", st, False)):
        eq = cfg.wire_bench(pkg, pkg.GridBox(Lx=600.0, Ly=600.0, Lz=800.0,
                                             nx=3, ny=3, nz=3),
                            fp32_phase=fp32, device="cpu")
        eq.enable_dia_matvec()
        cfg.elastic_init(eq)
        rows = eq.solve_time_steps(
            [(k + 1) * FP32_DT for k in range(N_STEPS)], [FP32_DT] * N_STEPS,
            tol=1e-8, maxiter=40)
        out[name] = _record(eq, rows, dict(
            accepted=getattr(eq, "fp32_accepted", None)))
    return out


@pytest.mark.parametrize("ref", ["jax", "port_f64"])
def test_fp32_phase_fields(fp32_runs, ref):
    """The port's f32 sweep against JAX's and against the port's f64-only
    path: the f64 finish pins the fixed point, so fields agree at 2e-7
    max|ref| (tests/test_msteps.py) and the converged flags are equal;
    iteration counts may differ where f32 rounding moves the sweep."""
    p, r = fp32_runs["port"], fp32_runs[ref]
    assert p["accepted"] == N_STEPS
    assert fp32_runs["port_f64"]["accepted"] == 0
    assert (r["rows"][:, 5] == 1).all()
    np.testing.assert_array_equal(p["rows"][:, 5], r["rows"][:, 5])
    for k in ("u", "sig_v", "eps_tot_v"):
        np.testing.assert_allclose(p[k], r[k], rtol=0,
                                   atol=2e-7 * np.abs(r[k]).max(), err_msg=k)


def test_fp32_disable_skips_the_sweep():
    """A true ``_fp32_disable`` (the dt-retry flag) runs the step as the
    pure-f64 path."""
    eq = cfg.wire_bench(st, st.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=2,
                                       ny=2, nz=2), fp32_phase=True,
                        device="cpu")
    cfg.elastic_init(eq)
    eq._fp32_disable = True
    eq.solve_time_step(FP32_DT, FP32_DT)
    assert eq.fp32_accepted == 0
    eq._fp32_disable = False
    eq.solve_time_step(2 * FP32_DT, FP32_DT)
    assert eq.fp32_accepted == 1


@pytest.mark.slow
def test_cavern600_golden_cpu():
    """The port on the CPU against tests/golden/torch_port_cavern600.npz
    (JAX, same 2level configuration): ~1 min on one thread."""
    eq = cfg.wire_bench(st, cfg.cavern600_grid(st), device="cpu")
    cfg.elastic_init(eq)
    with np.load(os.path.join(HERE, "golden",
                              "torch_port_cavern600.npz")) as z:
        _close(eq.u.numpy(), z["u_elastic"], 1e-8, "elastic u")
        rows = eq.solve_time_steps([(k + 1) * DT for k in range(N_STEPS)],
                                   [DT] * N_STEPS, tol=1e-8, maxiter=40)
        np.testing.assert_array_equal(rows[:, [0, 5]], z["rows"][:, [0, 5]])
        _close(eq.u.numpy(), z["u"], 1e-8, "u")
        _close(eq.sig_v.numpy(), z["sig_v"], 1e-8, "sig_v")


@pytest.mark.slow
def test_box17_golden_cpu():
    """The port on the CPU against tests/golden/torch_port_box17.npz (JAX,
    the same configuration: enable_dia_matvec, 2level, fp32_phase=True).
    The f64 finish pins the fields: elastic u at 1e-8, u and sig_v after 3
    steps at 2e-7 max|ref| (test_fp32_phase_fields), equal converged flags;
    fixed-point counts may differ where f32 rounding moves a sweep."""
    eq = cfg.wire_bench(st, cfg.box17_grid(st), fp32_phase=True,
                        device="cpu")
    eq.enable_dia_matvec()
    assert eq.kernel.dia.structured
    cfg.elastic_init(eq)
    with np.load(os.path.join(HERE, "golden", "torch_port_box17.npz")) as z:
        _close(eq.u.numpy(), z["u_elastic"], 1e-8, "elastic u")
        rows = eq.solve_time_steps([(k + 1) * DT for k in range(N_STEPS)],
                                   [DT] * N_STEPS, tol=1e-8, maxiter=40)
        np.testing.assert_array_equal(rows[:, 5], z["rows"][:, 5])
        for k in ("u", "sig_v"):
            np.testing.assert_allclose(
                getattr(eq, k).numpy(), z[k], rtol=0,
                atol=2e-7 * np.abs(z[k]).max(), err_msg=k)
