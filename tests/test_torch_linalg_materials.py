"""PyTorch port vs JAX package: batched 6x6/3x3 inverses and the four
main-path constitutive mechanisms, element by element on random stress and
internal-variable states.

Every check holds 1e-12 relative to the largest reference entry (most hold
bitwise).  That is the bound and not exact equality because XLA's CPU
``exp``/``log``/``pow`` and libm, which torch uses, differ in the last bit on
a few percent of inputs.  The Desai hardening linearization differences
rates at a 0.1 Pa stress probe; on these states its columns still agree
to about 1e-16 of their largest entry.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import safeincave_tpu as sc
import safeincave_torch as st
from safeincave_tpu.linalg import inv3x3 as jax_inv3x3
from safeincave_tpu.linalg import inv6x6_fast as jax_inv6x6_fast
from safeincave_torch.linalg import inv3x3, inv6x6_fast

torch.set_num_threads(1)

E_N = 64          # elements per batch
DT, THETA = 3600.0, 0.5


def _close(got, want, rtol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


# --------------------------------------------------------------------------- #
# linalg
# --------------------------------------------------------------------------- #
def test_inv6x6_fast_values_and_flags():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(E_N, 6, 6)) + 6.0 * np.eye(6)
    M *= 10.0 ** rng.uniform(-12, 12, size=(E_N, 1, 1))   # wide scales
    M[3] = 0.0                                   # all-zero: not ok
    M[7, 2, :] = 0.0                             # zero row: pivot collapse
    M[11, 0, 0] = np.nan                         # non-finite: not ok
    M[13, 4] = M[13, 1]                          # rank deficient
    inv_j, ok_j = jax_inv6x6_fast(jnp.asarray(M))
    inv_p, ok_p = inv6x6_fast(torch.as_tensor(M))
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_p.numpy(), ok_j)
    assert not ok_j[[3, 7, 11]].any() and ok_j.sum() >= E_N - 4
    good = ok_j
    for e in np.nonzero(good)[0]:   # per element: scales span 24 decades
        _close(inv_p[e], np.asarray(inv_j)[e], RTOL, f"inv6x6[{e}]")


_UTILS = {
    "tensor_to_voigt": lambda U, s6, s33, C: U.tensor_to_voigt(s33),
    "voigt_to_tensor": lambda U, s6, s33, C: U.voigt_to_tensor(s6),
    "dotdot_voigt": lambda U, s6, s33, C: U.dotdot(C, s6),
    "dotdot_tensor": lambda U, s6, s33, C: U.dotdot(C, s33),
    "dev_voigt": lambda U, s6, s33, C: U.dev_voigt(s6),
    "trace_voigt": lambda U, s6, s33, C: U.trace_voigt(s6),
    "norm_voigt": lambda U, s6, s33, C: U.norm_voigt(s6),
    "von_mises_voigt": lambda U, s6, s33, C: U.von_mises_voigt(s6),
}


@pytest.mark.parametrize("fn", sorted(_UTILS))
def test_voigt_utils_match_jax(fn):
    """Voigt maps and invariants: the same arithmetic in the same order, so
    1e-12 holds with room (most entries are bitwise equal)."""
    rng = np.random.default_rng(2)
    s6 = 1e6 * rng.normal(size=(E_N, 6))
    s33 = np.asarray(sc.Utils.voigt_to_tensor(jnp.asarray(s6)))
    C = rng.normal(size=(E_N, 6, 6))
    args = (s6, s33, C)
    want = _UTILS[fn](sc.Utils, *(jnp.asarray(a) for a in args))
    got = _UTILS[fn](st.Utils, *(torch.as_tensor(a) for a in args))
    assert tuple(got.shape) == tuple(np.shape(want))
    _close(got, want, RTOL, fn)


def test_voigt_weight_and_units_match_jax():
    like = torch.zeros(1, dtype=torch.float64)
    w = st.Utils.voigt_weight(like)
    assert w.dtype == torch.float64
    np.testing.assert_array_equal(w.numpy(), sc.Utils.VOIGT_WEIGHT)
    for unit in ("GPa", "MPa", "kPa", "minute", "hour", "day", "year"):
        assert getattr(st, unit) == getattr(sc, unit), unit


def test_inv3x3():
    rng = np.random.default_rng(1)
    M = rng.normal(size=(E_N, 3, 3)) + 3.0 * np.eye(3)
    M *= 10.0 ** rng.uniform(-10, 15, size=(E_N, 1, 1))
    want = np.asarray(jax_inv3x3(jnp.asarray(M)))
    got = inv3x3(torch.as_tensor(M)).numpy()
    for e in range(E_N):
        _close(got[e], want[e], RTOL, f"inv3x3[{e}]")


# --------------------------------------------------------------------------- #
# materials
# --------------------------------------------------------------------------- #
def _params(rng):
    """Bench-like parameters with per-element scatter."""
    u = lambda lo, hi: rng.uniform(lo, hi, size=E_N)  # noqa: E731
    return dict(
        kv=(105e11 * u(0.5, 2.0), 10e9 * u(0.8, 1.2), 0.32 * u(0.9, 1.1)),
        ds=(1.9e-20 * u(0.5, 2.0), 51600 * u(0.95, 1.05), 3.0 * u(0.9, 1.1)),
        desai=dict(
            mu_1=5.3665857009859815e-11 * u(0.5, 2.0), N_1=3.1 * u(0.9, 1.1),
            a_1=1.965018496922832e-05 * u(0.9, 1.1),
            eta=0.8275682807874163 * u(0.9, 1.1), n=3.0 * u(0.95, 1.05),
            beta_1=0.0048 * u(0.9, 1.1), beta=0.995 * np.ones(E_N),
            m=-0.5 * np.ones(E_N), gamma=0.095 * u(0.9, 1.1),
            sigma_t=5.0 * u(0.9, 1.1), alpha_0=0.0022 * u(0.5, 1.5)))


def _stress(rng):
    """Compressive MPa-scale states with deviatoric parts large enough that
    most elements yield in Desai; a few near-hydrostatic ones hit the J2
    floor."""
    sv = np.zeros((E_N, 6))
    sv[:, :3] = -1e6 * rng.uniform(5.0, 25.0, size=(E_N, 3))
    sv[:, 3:] = 1e6 * rng.uniform(-4.0, 4.0, size=(E_N, 3))
    sv[:4, :3] = -12e6
    sv[:4, 3:] = 0.0
    return sv


def _elements(pkg, p):
    return {
        "viscoelastic": pkg.Viscoelastic(*p["kv"]),
        "dislocation": pkg.DislocationCreep(*p["ds"]),
        "desai": pkg.ViscoplasticDesai(**p["desai"]),
    }


def _random_state(elem_jax, rng):
    """Random history for every state entry (same arrays for both)."""
    st_ = {}
    for k, v in elem_jax.state.items():
        v = np.asarray(v)
        if v.dtype == bool:
            st_[k] = rng.random(v.shape) < 0.1
        elif k in ("rate", "rate_old"):
            st_[k] = 1e-10 * rng.normal(size=v.shape)
        elif k in ("eps_old", "eps_k"):
            st_[k] = 1e-4 * rng.normal(size=v.shape)
        elif k == "alpha":
            st_[k] = np.asarray(elem_jax.params["alpha_0"]) \
                * rng.uniform(0.6, 1.2, v.shape)
        elif k in ("qsi", "qsi_old"):
            st_[k] = 1e-4 * rng.uniform(0.0, 1.0, v.shape)
        elif k == "h":
            st_[k] = rng.uniform(0.5, 2.0, v.shape)
        else:
            st_[k] = rng.normal(size=v.shape) * (1e-12 if k in ("G", "P")
                                                 else 1e-3)
    return st_


def _states(elem_jax, rng):
    s = _random_state(elem_jax, rng)
    to_t = lambda a: torch.as_tensor(a)  # noqa: E731
    return ({k: jnp.asarray(v) for k, v in s.items()},
            {k: to_t(v) for k, v in s.items()})


RTOL = 1e-12


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    p = _params(rng)
    return p, _elements(sc, p), _elements(st, p), _stress(rng), \
        298.0 * np.ones(E_N)


@pytest.mark.parametrize("name", ["viscoelastic", "dislocation", "desai"])
def test_f_tangent_rate_increment(setup, name):
    p, ej, ep, sv, T = setup
    ej, ep = ej[name], ep[name]
    rng = np.random.default_rng(11)
    sj, sp = _states(ej, rng)
    sv_k = sv * (1.0 + 1e-3 * rng.normal(size=sv.shape))
    svj, svp = jnp.asarray(sv), torch.as_tensor(sv)
    svkj, svkp = jnp.asarray(sv_k), torch.as_tensor(sv_k)
    Tj, Tp = jnp.asarray(T), torch.as_tensor(T)

    outj = ej.f_tangent(sj, svj, Tj, DT, THETA)
    outp = ep.f_tangent(sp, svp, Tp, DT, THETA)
    assert set(outp) == set(outj)
    for k in outj:
        _close(outp[k], outj[k], RTOL, f"{name} tangent {k}")

    # the remaining steps start from the JAX tangent output on both sides,
    # so each function is checked on identical inputs
    base = {k: np.asarray(v) for k, v in outj.items()}
    bj = {k: jnp.asarray(v) for k, v in base.items()}
    bp = {k: torch.as_tensor(v) for k, v in base.items()}
    rj = ej.f_rate(bj, svj, DT * THETA, Tj)
    rp = ep.f_rate(bp, svp, DT * THETA, Tp)
    for k in rj:
        _close(rp[k], rj[k], RTOL, f"{name} rate {k}")
    if name == "desai":   # the states must exercise the yielding branch
        assert (np.asarray(rj["Fvp"]) > 0).mean() > 0.5

    ij = ej.f_increment_isv(bj, svj, svkj, DT)
    ip = ep.f_increment_isv(bp, svp, svkp, DT)
    for k in ij:
        _close(ip[k], ij[k], RTOL, f"{name} increment {k}")

    for fn in ("f_commit_isv", "f_rate_to_old"):
        for k, v in getattr(ej, fn)(bj).items():
            _close(getattr(ep, fn)(bp)[k], v, 0.0, f"{name} {fn} {k}")
    uj = ej.f_update_eps_old(bj, svj, svkj, DT * (1 - THETA))
    up = ep.f_update_eps_old(bp, svp, svkp, DT * (1 - THETA))
    _close(up["eps_old"], uj["eps_old"], RTOL, f"{name} eps_old")


def test_desai_initial_hardening(setup):
    p, ej, ep, sv, T = setup
    ej, ep = ej["desai"], ep["desai"]
    ej.compute_initial_hardening(jnp.asarray(sv))
    ep.compute_initial_hardening(torch.as_tensor(sv))
    _close(ep.alpha_0, ej.alpha_0, RTOL, "alpha_0")
    _close(ep.Fvp, ej.Fvp, RTOL, "Fvp")
    np.testing.assert_array_equal(ep.ind_desai_disabled.numpy(),
                                  np.asarray(ej.ind_desai_disabled))


def test_spring_matches_jax(setup):
    sv = setup[3]
    E, nu = 102e9 * np.ones(E_N), 0.3 * np.ones(E_N)
    sj, sp = sc.Spring(E, nu), st.Spring(E, nu)
    sj.initialize()
    sp.initialize()
    for k in ("C", "C_inv", "K"):
        _close(getattr(sp, k), getattr(sj, k), 0.0, f"spring {k}")
    sj.compute_eps_e(jnp.asarray(sv))
    sp.compute_eps_e(torch.as_tensor(sv))
    _close(sp.eps_e, sj.eps_e, RTOL, "spring eps_e")


def _material(pkg, p):
    mat = pkg.Material(E_N)
    mat.add_to_elastic(pkg.Spring(102e9 * np.ones(E_N), 0.3 * np.ones(E_N)))
    for e in _elements(pkg, p).values():
        mat.add_to_non_elastic(e)
    return mat


def test_material_tangent_and_CT_with_fallback(setup):
    p, _, _, sv, T = setup
    mj, mp = _material(sc, p), _material(st, p)
    _close(mp.C, mj.C, 0.0, "C")
    rng = np.random.default_rng(5)
    statesj, statesp = [], []
    for e in mj.elems_ne:
        sj, sp = _states(e, rng)
        statesj.append(sj)
        statesp.append(sp)
    _, Gj, Bj = mj.f_tangent_all(statesj, jnp.asarray(sv), jnp.asarray(T),
                                 DT, THETA)
    _, Gp, Bp = mp.f_tangent_all(statesp, torch.as_tensor(sv),
                                 torch.as_tensor(T), DT, THETA)
    _close(Gp, Gj, RTOL, "G")
    _close(Bp, Bj, RTOL, "B")

    # CT from one shared G, with singular and non-finite elements so the
    # elastic fallback is exercised
    G = np.asarray(Gj).copy()
    G[0] = -np.asarray(mj.C_inv)[0] / (DT * (1 - THETA))   # singular
    G[1, 2, 3] = np.nan                                      # non-finite
    CTj = mj.f_CT(jnp.asarray(G), DT, THETA)
    CTp = mp.f_CT(torch.as_tensor(G), DT, THETA)
    fallback = np.linalg.inv(np.asarray(mj.C_inv)[0])
    np.testing.assert_array_equal(CTp[0].numpy(), fallback)
    np.testing.assert_array_equal(CTp[1].numpy(), np.asarray(CTj)[1])
    for e in range(E_N):
        _close(CTp[e], np.asarray(CTj)[e], RTOL, f"CT[{e}]")


def _f32(state):
    return {k: v.float() if v.is_floating_point() else v
            for k, v in state.items()}


def _jf32(state):
    return {k: v.astype(jnp.float32) if jnp.issubdtype(v.dtype, jnp.floating)
            else v for k, v in state.items()}


F32_RTOL = 1e-5


def test_f32_material_path(setup):
    """The f32 fixed-point sweep's materials: an f32 state and stress give
    f32 outputs through f_tangent_all, f_CT, f_eps_k, f_increment_isv and
    f_rate (an f64 parameter or constant would promote them), and the
    tangents match JAX's f32 path at 1e-5 max|ref|: XLA and torch round the
    f32 exp/pow, the JVPs and the widened Desai probes differently (measured
    ~1e-6).  f_CT from one shared f32 G agrees to the same bound."""
    p, _, _, sv, T = setup
    mj, mp = _material(sc, p), _material(st, p)
    rng = np.random.default_rng(9)
    statesj, statesp = [], []
    for e in mj.elems_ne:
        sj, sp = _states(e, rng)
        statesj.append(_jf32(sj))
        statesp.append(_f32(sp))
    f32 = torch.float32
    svp, Tp = torch.as_tensor(sv, dtype=f32), torch.as_tensor(T, dtype=f32)
    svj, Tj = jnp.asarray(sv, jnp.float32), jnp.asarray(T, jnp.float32)
    nsj, Gj, Bj = mj.f_tangent_all(statesj, svj, Tj, DT, THETA)
    nsp, Gp, Bp = mp.f_tangent_all(statesp, svp, Tp, DT, THETA)
    assert Gp.dtype == Bp.dtype == f32
    _close(Gp, Gj, F32_RTOL, "f32 G")
    _close(Bp, Bj, F32_RTOL, "f32 B")
    G = np.asarray(Gj).copy()
    G[1, 2, 3] = np.nan           # ok-flag False: the f32 elastic fallback
    CTp = mp.f_CT(torch.as_tensor(G), DT, THETA)
    assert CTp.dtype == f32
    np.testing.assert_array_equal(
        CTp[1].numpy(), np.linalg.inv(np.asarray(mj.C_inv)[1]).astype(
            np.float32))
    _close(CTp, mj.f_CT(jnp.asarray(G), DT, THETA), F32_RTOL, "f32 CT")
    for ej, ep, sj, sp in zip(mj.elems_ne, mp.elems_ne, nsj, nsp):
        outs = (ep.f_eps_k(sp, DT * THETA, DT * (1 - THETA)),
                ep.f_increment_isv(sp, svp, 1.001 * svp, DT),
                ep.f_rate(sp, svp, DT * THETA, Tp))
        for out in (sp,) + outs:
            for k, v in out.items():
                assert v.dtype in (f32, torch.bool), (ep.name, k, v.dtype)
        _close(outs[2]["rate"], ej.f_rate(sj, svj, DT * THETA, Tj)["rate"],
               F32_RTOL, f"{ep.name} f32 rate")
