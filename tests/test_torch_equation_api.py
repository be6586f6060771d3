"""PyTorch port vs JAX package: the reference-style equation surface.

``set_material`` calling ``initialize`` (the hook the 1_triaxial example
overrides), the mutating one-step path (``compute_CT``, ``compute_eps_rhs``,
``solve``, ``compute_stress``), ``MomentumKernel.diagonal``, the
volumetric/deviatoric splits of the materials and the bf16 dense
preconditioner.  Same numpy inputs on both sides, the port on the CPU.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_tpu.fem.kernels import MomentumKernel as JaxKernel
from safeincave_tpu.fem.momentum import build_preconditioner as jax_precond
from safeincave_torch.fem.kernels import MomentumKernel
from safeincave_torch.fem.momentum import build_preconditioner

torch.set_num_threads(1)

DT = cfg.HOUR


def _close(got, want, tol, what="", scale=0.0):
    """Within ``tol`` of max|want| (or of ``scale``, for a quantity that
    cancels to rounding noise of its source)."""
    got, want = cfg.as_np(got), np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=tol, err_msg=what,
        atol=tol * max(np.abs(want).max(), scale, 1e-300))


def _zeros(pkg, *shape):
    return (torch.zeros(shape, dtype=torch.float64) if pkg is st
            else jnp.zeros(shape))


def _subclass(pkg):
    class Mod(pkg.LinearMomentum):
        """examples/mechanics/1_triaxial's idiom: fields of its own, set in
        ``initialize`` and filled in ``run_after_solve``."""

        def initialize(self):
            super().initialize()
            self.eps_cr = _zeros(pkg, self.n_elems, 3, 3)
            self.calls = getattr(self, "calls", 0) + 1

        def run_after_solve(self):
            self.eps_cr = self.mat.elems_ne[-1].eps_ne_k

    return Mod


def _small(pkg, cls=None, kelvin=True):
    """cfg.small_box with another equation class."""
    eq0 = cfg.small_box(pkg, device="cpu", kelvin=kelvin)
    if cls is None:
        return eq0
    eq = cls(eq0.grid, theta=0.5, **cfg.on(pkg, "cpu"))
    eq.set_solver(eq0.solver)
    eq.set_material(eq0.mat)
    eq.set_T0(298.0 * np.ones(eq.n_elems))
    eq.set_T(298.0 * np.ones(eq.n_elems))
    eq.build_body_force([0.0, 0.0, 0.0])
    momBC = pkg.MomentumBC
    bc = momBC.BcHandler(eq)
    tv = [0.0, 1e9]
    for nm, comp in (("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2)):
        bc.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.], tv))
    bc.add_boundary_condition(momBC.NeumannBC("TOP", 2, 0.0, 0.0,
                                              [10e6, 10e6], tv, g=0.0))
    eq.set_boundary_conditions(bc)
    return eq


@pytest.mark.parametrize("pkg", [sc, st], ids=["jax", "torch"])
def test_set_material_calls_initialize_of_a_subclass(pkg):
    eq = _small(pkg, _subclass(pkg))
    assert eq.calls == 1 and eq.C is eq.mat.C
    assert tuple(eq.eps_cr.shape) == (eq.n_elems, 3, 3)
    cfg.elastic_init(eq)
    ite, err = eq.solve_time_step(DT, DT, tol=1e-8, maxiter=20)
    assert err <= 1e-8
    assert float(abs(cfg.as_np(eq.eps_cr)).max()) > 0.0


def test_subclass_runs_through_simulator_like_the_jax_package(tmp_path):
    """The 1_triaxial workflow: the subclass through ``Simulator_M``."""
    out = {}
    for pkg in (sc, st):
        eq = _small(pkg, _subclass(pkg))
        tc = pkg.TimeController(dt=1.0, initial_time=0.0, final_time=3.0,
                                time_unit="hour")
        pkg.Simulator_M(eq, tc, [], compute_elastic_response=True).run()
        out[pkg] = eq
    _close(out[st].u, out[sc].u, 1e-8, "u")
    _close(out[st].eps_cr, out[sc].eps_cr, 1e-8, "eps_cr")


def test_solve_matches_the_jax_package():
    """tests/test_fem.py's use of ``eq.solve``: elastic response, rates,
    then linearized steps by hand with the reference-style calls."""
    eqs = {pkg: _small(pkg) for pkg in (sc, st)}
    for pkg, eq in eqs.items():
        cfg.elastic_init(eq)
        for k in range(2):
            sig_k = eq.sig_v
            eq.solve(sig_k, (k + 1) * DT, DT)
            eps = eq.compute_total_strain()
            eq.compute_stress(eps)
            eq.increment_internal_variables(eq.sig_v, sig_k, DT)
            eq.compute_eps_ne_rate(eq.sig_v, DT)
            eq.update_internal_variables()
            eq.update_eps_ne_old(eq.sig_v, sig_k, DT)
            eq.update_eps_ne_rate_old()
    p, j = eqs[st], eqs[sc]
    for k in ("u", "sig_v", "eps_rhs_v"):
        _close(getattr(p, k), getattr(j, k), 1e-10, k)
    _close(p.mat.CT, j.mat.CT, 1e-12, "CT")
    _close(p.mat.G, j.mat.G, 1e-12, "G")
    _close(p.mat.B6, j.mat.B6, 1e-12, "B6")


def test_diagonal_matches_and_is_the_operators_diagonal():
    grid_j = sc.GridBox(Lx=2.0, Ly=1.0, Lz=1.5, nx=3, ny=2, nz=3)
    grid_p = st.GridBox(Lx=2.0, Ly=1.0, Lz=1.5, nx=3, ny=2, nz=3)
    rng = np.random.default_rng(3)
    A = rng.normal(size=(grid_j.n_elems, 6, 6))
    CT = A @ A.transpose(0, 2, 1) + 6 * np.eye(6)
    kp = MomentumKernel(grid_p, "cpu")
    d_p = kp.diagonal(torch.as_tensor(CT))
    d_j = JaxKernel(grid_j).diagonal(jnp.asarray(CT))
    _close(d_p, d_j, 1e-12)
    # column 3n + i of the operator, read at its own row
    CT_soa = kp.prep(torch.as_tensor(CT))
    for n, i in ((0, 0), (5, 2), (grid_p.n_nodes - 1, 1)):
        e = torch.zeros((grid_p.n_nodes, 3), dtype=torch.float64)
        e[n, i] = 1.0
        assert abs(float(kp.matvec(CT_soa, e)[n, i]) - float(d_p[n, i])) \
            <= 1e-12 * float(d_p.abs().max())
    assert torch.equal(kp.diagonal(torch.as_tensor(CT)), d_p)


def test_material_splits_match():
    n = 12
    rng = np.random.default_rng(5)
    sig = -1e6 * (5.0 + rng.random((n, 6)))
    mats = {}
    for pkg in (sc, st):
        mat = cfg.bench_material(pkg, n, "cpu")
        mat.compute_G_B(sig, DT, 0.5, 298.0 * np.ones(n))
        mat.compute_T_IT()
        mat.compute_Bvol_Tvol()
        mat.compute_Gtilde_Btilde()
        mat.compute_CT_tilde(DT, 0.5)
        mats[pkg] = mat
    p, j = mats[st], mats[sc]
    # the column sums of a deviatoric G cancel: hold them to G's scale
    g_all = float(np.abs(np.asarray(j.G)).max())
    for k in ("IT", "T6", "B_vol", "T_vol", "G_tilde", "B_tilde6",
              "CT_tilde", "C_tilde", "C_tilde_inv"):
        _close(getattr(p, k), getattr(j, k), 1e-12, k, scale=g_all)
    for e_p, e_j in zip(p.elems_ne, j.elems_ne):
        g = float(np.abs(np.asarray(e_j.state["G"])).max())
        for k in ("T", "IT", "T_vol", "B_vol", "G_tilde", "B_tilde"):
            _close(e_p.state[k], e_j.state[k], 1e-12, f"{e_p.name}.{k}",
                   scale=g)


def test_precond_bf16_apply_and_solve(monkeypatch):
    """The bf16 dense inverse: stored in bfloat16, applied with f32 sums,
    within 1e-2 of max|ref| of the JAX package's apply; the solve's fields
    are the f32-inverse solve's at 1e-8 (the preconditioner moves the
    iteration count, not the solution).  The JAX package's dense build
    reads ``os`` without importing it: the test lends it the module and
    leaves its disk cache off."""
    import os
    import safeincave_tpu.fem.momentum as jax_momentum
    monkeypatch.setattr(jax_momentum, "os", os, raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    def box(pkg):
        return pkg.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=3, ny=3, nz=3)

    eq_p = cfg.wire_bench(st, box(st), precond="dense", device="cpu")
    eq_p.bc.update_dirichlet(0.0)
    eq_j = cfg.wire_bench(sc, box(sc), precond="dense")
    eq_j.bc.update_dirichlet(0.0)
    s_p = st.SolverSettings(precond="dense", precond_bf16=True)
    s_j = sc.SolverSettings(precond="dense", precond_bf16=True)
    (inv_p,), apply_p = build_preconditioner(eq_p.kernel, eq_p.mat.C,
                                             eq_p.bc.mask, s_p)
    (inv_j,), apply_j = jax_precond(eq_j.kernel, eq_j.mat.C, eq_j.bc.mask,
                                    s_j)
    assert inv_p.dtype == torch.bfloat16 and inv_j.dtype == jnp.bfloat16
    r = np.random.default_rng(1).normal(size=(eq_p.n_nodes, 3))
    for dt_t, dt_j in ((torch.float32, jnp.float32),
                       (torch.float64, jnp.float64)):
        z_p = apply_p((inv_p,), torch.as_tensor(r).to(dt_t), None)
        z_j = np.asarray(apply_j((inv_j,), jnp.asarray(r, dtype=dt_j), None))
        assert z_p.dtype == dt_t
        np.testing.assert_allclose(z_p.numpy(), z_j, rtol=0,
                                   atol=1e-2 * np.abs(z_j).max())

    fields = {}
    for bf16 in (False, True):
        eq = cfg.wire_bench(st, box(st), precond="dense", device="cpu")
        eq.set_solver(st.SolverSettings(precond="dense", fp32_phase=False,
                                        precond_bf16=bf16, **cfg.SETTINGS))
        cfg.elastic_init(eq)
        rows = eq.solve_time_steps([DT, 2 * DT], [DT, DT], tol=1e-8,
                                   maxiter=40)
        assert (rows[:, 5] == 1).all()
        fields[bf16] = (eq.u.numpy(), eq.sig_v.numpy())
    for a, b in zip(fields[True], fields[False]):
        np.testing.assert_allclose(a, b, rtol=1e-8,
                                   atol=1e-8 * np.abs(b).max())
