"""PyTorch port vs JAX package: the pivoted 6x6 inverse and solve, the
analytic 3x3 eigenvalues, and the four mechanisms that complete the JSON
schema (pressure-solution and Munson-Dawson creep, Mohr-Coulomb and
Matsuoka-Nakai viscoplasticity), element by element on seeded stress and
internal-variable states.

Linear algebra holds 1e-12 of the largest reference entry; the mechanisms'
``f_rate``, ``f_tangent`` (G, B and Munson-Dawson's r, h, P) and
``f_increment_isv`` hold 1e-10 in float64 (the port takes every
Munson-Dawson derivative from one stacked forward-mode pass where the JAX
package mixes forward and reverse passes, and XLA's and libm's ``exp``,
``log`` and ``pow`` differ in the last bit).  One exception: on an element
whose tension cut-off is active the JAX package's flow direction is
``-ISO6 / 3`` with a float32 ``ISO6``, so its 1/3 is float32's
(relative error 3e-8); the port's is float64's, and those elements' rates
are held to 1e-7 instead.  The Matsuoka-Nakai Jacobian is
held against ``jax.jacfwd`` on hydrostatic and triaxial states too, where
the eigenvalues repeat: both packages give the same finite entries and NaN
in the same places.  The four kinds then run through the JSON driver of both
packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg
from safeincave_tpu import linalg as jl
from safeincave_tpu import postproc
from safeincave_torch import linalg as pl

torch.set_num_threads(1)

E_N = 48
DT, THETA = 3600.0, 0.5
RTOL = 1e-10


def _close(got, want, rtol, what, equal_nan=False):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = max(np.nanmax(np.abs(want)), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what, equal_nan=equal_nan)


# --------------------------------------------------------------------------- #
# linalg
# --------------------------------------------------------------------------- #
def _matrices():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(E_N, 6, 6)) + 2.0 * np.eye(6)
    M *= 10.0 ** rng.uniform(-12, 12, size=(E_N, 1, 1))
    M[2, [0, 5]] = M[2, [5, 0]]                  # needs a row swap
    M[2, 5, 5] = 0.0
    M[3] = 0.0                                   # all-zero: not ok
    M[7, 2, :] = 0.0                             # zero row
    M[11, 0, 0] = np.nan                         # non-finite
    return M, rng.normal(size=(E_N, 6))


def test_inv6x6_pivoted_values_and_flags():
    M, _ = _matrices()
    inv_j, ok_j = jl.inv6x6(jnp.asarray(M))
    inv_p, ok_p = pl.inv6x6(torch.as_tensor(M))
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_p.numpy(), ok_j)
    assert not ok_j[[3, 7, 11]].any() and ok_j[2] and ok_j.sum() == E_N - 3
    for e in np.nonzero(ok_j)[0]:     # per element: scales span 24 decades
        _close(inv_p[e], np.asarray(inv_j)[e], 1e-12, f"inv6x6[{e}]")
    eye = inv_p[2].numpy() @ M[2]
    np.testing.assert_allclose(eye, np.eye(6), atol=1e-9)


def test_solve6x6():
    M, b = _matrices()
    x_j, ok_j = jl.solve6x6(jnp.asarray(M), jnp.asarray(b))
    x_p, ok_p = pl.solve6x6(torch.as_tensor(M), torch.as_tensor(b))
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    for e in np.nonzero(np.asarray(ok_j))[0]:
        _close(x_p[e], np.asarray(x_j)[e], 1e-12, f"solve6x6[{e}]")


def _sym3():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(E_N, 3, 3))
    A = 0.5 * (A + A.transpose(0, 2, 1)) * 10.0 ** rng.uniform(
        -3, 8, size=(E_N, 1, 1))
    A[0] = 7.0 * np.eye(3)                          # isotropic
    A[1] = np.diag([2.0, 2.0, 5.0])                 # repeated pair
    A[2] = 0.0
    return A


def test_eigvalsh3x3():
    A = _sym3()
    want = np.asarray(jl.eigvalsh3x3(jnp.asarray(A)))
    got = pl.eigvalsh3x3(torch.as_tensor(A)).numpy()
    ref = np.linalg.eigvalsh(A)
    for e in range(E_N):
        scale = max(np.abs(want[e]).max(), 1e-300)
        assert np.abs(got[e] - want[e]).max() <= 1e-12 * scale, e
        assert np.abs(got[e] - ref[e]).max() <= 1e-9 * scale, e


# --------------------------------------------------------------------------- #
# mechanisms
# --------------------------------------------------------------------------- #
def _params(rng):
    u = lambda lo, hi: rng.uniform(lo, hi, size=E_N)  # noqa: E731
    perfect = dict(mu_1=1e-9 * u(0.5, 2.0), N_1=u(1.0, 3.0),
                   cohesion=u(0.5, 4.0), friction_angle=np.radians(u(20, 40)),
                   dilation_angle=np.radians(u(0, 15)), sigma_t=u(0.5, 5.0))
    return {
        "pressure_solution": (sc.PressureSolutionCreep,
                              st.PressureSolutionCreep,
                              dict(A=1.29e-15 * u(0.5, 2.0),
                                   d=5e-3 * u(0.5, 2.0),
                                   Q=51600 * u(0.95, 1.05))),
        "munson_dawson": (sc.MunsonDawsonCreep, st.MunsonDawsonCreep,
                          dict(A=1.9e-20 * u(0.5, 2.0),
                               Q=51600 * u(0.95, 1.05), n=3.0 * u(0.9, 1.1),
                               K0=1e-6 * u(0.5, 2.0),
                               c=0.009198 * np.ones(E_N),
                               m=3.0 * u(0.95, 1.05),
                               alpha_w=-17.37 * u(0.9, 1.1),
                               beta_w=-7.738 * u(0.9, 1.1),
                               delta=0.58 * u(0.9, 1.1),
                               mu=12.4e9 * u(0.9, 1.1))),
        "mohr_coulomb": (sc.MohrCoulombViscoplastic,
                         st.MohrCoulombViscoplastic, perfect),
        "matsuoka_nakai": (sc.MatsuokaNakaiViscoplastic,
                           st.MatsuokaNakaiViscoplastic, perfect),
    }


NAMES = ["pressure_solution", "munson_dawson", "mohr_coulomb",
         "matsuoka_nakai"]


def _stress(rng):
    """Compressive MPa-scale states with large deviators (most elements
    yield in the frictional models) and a few in net tension beyond the
    cut-off."""
    sv = np.zeros((E_N, 6))
    sv[:, :3] = -1e6 * rng.uniform(2.0, 30.0, size=(E_N, 3))
    sv[:, 3:] = 1e6 * rng.uniform(-6.0, 6.0, size=(E_N, 3))
    sv[-4:, :3] = 1e6 * rng.uniform(4.0, 8.0, size=(4, 3))
    return sv


def _pair(name):
    rng = np.random.default_rng(7)
    cls_j, cls_p, kw = _params(rng)[name]
    return cls_j(**kw), cls_p(**kw, device="cpu"), _stress(rng), \
        rng.uniform(290.0, 330.0, size=E_N), rng


def _random_state(elem_jax, rng):
    out = {}
    for k, v in elem_jax.state.items():
        v = np.asarray(v)
        if v.dtype == bool:
            out[k] = rng.random(v.shape) < 0.1
        elif k in ("rate", "rate_old"):
            out[k] = 1e-10 * rng.normal(size=v.shape)
        elif k in ("eps_old", "eps_k"):
            out[k] = 1e-4 * rng.normal(size=v.shape)
        elif k in ("zeta", "zeta_old"):
            # below and above the transient limit: both branches of F
            out[k] = 10.0 ** rng.uniform(-16, -11, v.shape)
        elif k == "h":
            out[k] = rng.uniform(0.5, 2.0, v.shape)
        else:
            out[k] = rng.normal(size=v.shape) * (1e-12 if k in ("G", "P")
                                                 else 1e-3)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_rate_tangent_increment_match_jax(name):
    ej, ep, sv, T, rng = _pair(name)
    for k, v in ej.params.items():
        _close(ep.params[k], v, 1e-15, f"{name} param {k}")
    s = _random_state(ej, rng)
    assert set(s) == set(ep.state)
    sj = {k: jnp.asarray(v) for k, v in s.items()}
    sp = {k: torch.as_tensor(v) for k, v in s.items()}
    sv_k = sv * (1.0 + 1e-3 * rng.normal(size=sv.shape))
    svj, svp = jnp.asarray(sv), torch.as_tensor(sv)
    Tj, Tp = jnp.asarray(T), torch.as_tensor(T)

    rj = ej.f_rate(sj, svj, DT * THETA, Tj)
    rp = ep.f_rate(sp, svp, DT * THETA, Tp)
    assert set(rp) == set(rj)
    # elements on the tension cut-off (net tension: the last four states)
    cut = np.zeros(E_N, dtype=bool)
    if "Fvp" in rj:
        cut = sv[:, :3].sum(1) > 0
        assert cut.sum() == 4
    for k in rj:
        _close(rp[k][~cut], np.asarray(rj[k])[~cut], RTOL,
               f"{name} rate {k}")
        if cut.any():
            _close(rp[k][cut], np.asarray(rj[k])[cut], 1e-7,
                   f"{name} rate {k} (tension cut-off)")
    assert np.abs(np.asarray(rj["rate"])).max() > 0
    if "Fvp" in rj:       # both the yielding and the elastic branch
        frac = (np.asarray(rj["Fvp"]) > 0).mean()
        assert 0.2 < frac < 1.0, frac

    tj = ej.f_tangent(sj, svj, Tj, DT, THETA)
    tp = ep.f_tangent(sp, svp, Tp, DT, THETA)
    assert set(tp) == set(tj)
    for k in tj:
        # per element: the tangent's scale follows the stress state
        for e in range(E_N):
            _close(tp[k][e], np.asarray(tj[k])[e], 1e-7 if cut[e] else RTOL,
                   f"{name} tangent {k}[{e}]")
    assert np.isfinite(np.asarray(tj["G"])).all()

    base = {k: np.asarray(v) for k, v in tj.items()}
    ij = ej.f_increment_isv({k: jnp.asarray(v) for k, v in base.items()},
                            svj, jnp.asarray(sv_k), DT)
    ip = ep.f_increment_isv({k: torch.as_tensor(v) for k, v in base.items()},
                            svp, torch.as_tensor(sv_k), DT)
    for k in ij:
        _close(ip[k], ij[k], RTOL, f"{name} increment {k}")
    cj = ej.f_commit_isv({k: jnp.asarray(v) for k, v in base.items()})
    cp = ep.f_commit_isv({k: torch.as_tensor(v) for k, v in base.items()})
    for k in cj:
        _close(cp[k], cj[k], 0.0, f"{name} commit {k}")


def test_munson_dawson_branches_and_clamp():
    """The seeded zeta straddle the transient limit (hardening and recovery
    branches of F), the increment's clamp at zero is hit, and the views and
    ``compute_residue`` match."""
    ej, ep, sv, T, rng = _pair("munson_dawson")
    s = _random_state(ej, rng)
    ej.state = {k: jnp.asarray(v) for k, v in s.items()}
    ep.state = {k: torch.as_tensor(v) for k, v in s.items()}
    ej.compute_eps_ne_rate(jnp.asarray(sv), DT * THETA, jnp.asarray(T))
    ep.compute_eps_ne_rate(torch.as_tensor(sv), DT * THETA,
                           torch.as_tensor(T))
    below = s["zeta"] <= np.asarray(ej.state["eps_t_star"])
    assert 0 < below.sum() < E_N
    ej.compute_G_B(jnp.asarray(sv), DT, THETA, jnp.asarray(T))
    ep.compute_G_B(torch.as_tensor(sv), DT, THETA, torch.as_tensor(T))
    ej.increment_internal_variables(jnp.asarray(sv), jnp.asarray(1.2 * sv),
                                    DT)
    ep.increment_internal_variables(torch.as_tensor(sv),
                                    torch.as_tensor(1.2 * sv), DT)
    assert (np.asarray(ej.zeta) == 0.0).any()
    for view in ("zeta", "zeta_old", "F", "P", "r", "h"):
        _close(getattr(ep, view), getattr(ej, view), RTOL, view)
    _close(ep.compute_residue(torch.as_tensor(sv), s["zeta"], T, DT),
           ej.compute_residue(jnp.asarray(sv), s["zeta"], T, DT), RTOL,
           "residue")


def test_munson_dawson_f32_floor():
    """In float32 the transient limit is floored at 1e-30 (1e-50 would
    flush to zero and zeta / eps_t_star overflow): a vanishing limit gives
    finite float32 rate, F and tangent, close to JAX's float32 path."""
    ej, ep, sv, T, rng = _pair("munson_dawson")
    tiny = dict(K0=1e-45 * np.ones(E_N))
    ej.params = dict(ej.params, **tiny)
    ep.params = dict(ep.params, K0=torch.as_tensor(tiny["K0"]))
    s = _random_state(ej, rng)
    f32 = torch.float32
    sj = {k: jnp.asarray(v, jnp.float32) if v.dtype != bool else
          jnp.asarray(v) for k, v in s.items()}
    sp = {k: torch.as_tensor(v, dtype=f32) if v.dtype != bool else
          torch.as_tensor(v) for k, v in s.items()}
    svp, Tp = torch.as_tensor(sv, dtype=f32), torch.as_tensor(T, dtype=f32)
    svj, Tj = jnp.asarray(sv, jnp.float32), jnp.asarray(T, jnp.float32)
    rp = ep.f_rate(sp, svp, DT * THETA, Tp)
    rj = ej.f_rate(sj, svj, DT * THETA, Tj)
    assert rp["rate"].dtype == rp["F"].dtype == f32
    assert float(rp["eps_t_star"].min()) == float(np.float32(1e-30))
    assert torch.isfinite(rp["rate"]).all() and torch.isfinite(rp["F"]).all()
    _close(rp["rate"], rj["rate"], 1e-5, "f32 rate")
    tp = ep.f_tangent(sp, svp, Tp, DT, THETA)
    for k, v in tp.items():
        assert v.dtype in (f32, torch.bool), k
        assert torch.isfinite(v.float()).all(), k
    # float64 keeps the 1e-50 floor
    r64 = ep.f_rate({k: v.double() if v.is_floating_point() else v
                     for k, v in sp.items()}, svp.double(), DT * THETA,
                    Tp.double())
    assert float(r64["eps_t_star"].min()) == 1e-50


SPECIAL = {
    "hydrostatic": [-12e6, -12e6, -12e6, 0.0, 0.0, 0.0],
    "triaxial_compression": [-5e6, -5e6, -30e6, 0.0, 0.0, 0.0],
    "triaxial_extension": [-20e6, -20e6, -4e6, 0.0, 0.0, 0.0],
    "near_triaxial": [-5e6, -5e6 * (1 + 1e-9), -30e6, 1.0, 0.0, 0.0],
    "generic": [-5e6, -9e6, -30e6, 2e6, -1e6, 3e6],
}


@pytest.mark.parametrize("state", sorted(SPECIAL))
def test_matsuoka_nakai_jacobian_matches_jacfwd(state):
    """The port's stacked-JVP Jacobian of the rate against ``jax.jacfwd``
    of the JAX rate at states where the eigenvalues repeat.  No guard is
    added that the JAX function lacks: where its derivative is not finite
    (arccos at +-1 on an exactly triaxial state), the port's is not finite
    in the same entries."""
    one = np.ones(1)
    kw = dict(mu_1=1e-9 * one, N_1=1.5 * one, cohesion=1.0 * one,
              friction_angle=np.radians(30.0) * one,
              dilation_angle=np.radians(10.0) * one, sigma_t=1.0 * one)
    ej = sc.MatsuokaNakaiViscoplastic(**kw)
    ep = st.MatsuokaNakaiViscoplastic(**kw, device="cpu")
    sv = np.asarray([SPECIAL[state]])
    T = 298.0 * one
    p0 = {k: v[0] for k, v in ej.params.items()}
    jac = np.asarray(jax.jacfwd(
        lambda s: ej._rate_one(s, {}, T[0], p0))(jnp.asarray(sv[0])))
    want = jac * np.asarray(sc.Utils.VOIGT_WEIGHT)
    got = ep._E_exact(torch.as_tensor(sv), {}, torch.as_tensor(T))[0].numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    if np.isfinite(want).any():
        _close(np.where(np.isfinite(want), got, 0.0),
               np.where(np.isfinite(want), want, 0.0), RTOL, state)
    if state in ("generic", "near_triaxial", "hydrostatic"):
        assert np.isfinite(want).all()
    # the whole-element tangent agrees with the JAX package's as well
    tj = ej.f_tangent(ej.state, jnp.asarray(sv), jnp.asarray(T), DT, THETA)
    tp = ep.f_tangent(ep.state, torch.as_tensor(sv), torch.as_tensor(T), DT,
                      THETA)
    _close(tp["G"], tj["G"], RTOL, f"{state} G", equal_nan=True)


# --------------------------------------------------------------------------- #
# the JSON driver
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", sorted(cfg.JSON_KINDS))
def test_json_kind_runs_and_matches_jax(tmp_path, kind):
    """A two-stage JSON case whose operation stage adds one element of
    ``kind`` to the creep of ``torch_port_configs.box_case``: the port's
    operation-stage u and q_elems against the JAX driver's at 1e-8 of
    max|ref| (Munson-Dawson starts after an equilibrium stage, as its users
    run it)."""
    grid_dir = tmp_path / "grid"
    grid_dir.mkdir()
    st.mesh.write_msh(str(grid_dir / "geom.msh"),
                      *st.mesh.box_mesh(nx=2, ny=2, nz=2))
    sims = {}
    for pkg, sub in ((st, "port"), (sc, "jax")):
        case = cfg.box_case(grid_dir, tmp_path / sub)
        case["constitutive_model"]["nonelastic"]["extra"] = {
            "type": kind, "active": True, "equilibrium": False,
            "parameters": dict(cfg.JSON_KINDS[kind])}
        sim = pkg.Simulator_GUI(case, **cfg.on(pkg, "cpu"))
        sim.run()
        sims[sub] = sim
    extra = sims["port"].mom_eq.mat.elems_ne[-1]
    assert type(extra).__name__ == kind and extra.name == "extra"
    assert float(extra.state["rate"].abs().max()) > 0
    for field in ("u", "q_elems"):
        t_ref, ref, _, _ = postproc.read_timeseries(
            str(tmp_path / "jax" / "operation"), field)
        t, got, _, _ = postproc.read_timeseries(
            str(tmp_path / "port" / "operation"), field)
        np.testing.assert_array_equal(t, t_ref)
        for k in range(ref.shape[0]):
            scale = np.abs(ref[k]).max()
            assert np.abs(got[k] - ref[k]).max() <= 1e-8 * scale, (field, k)
