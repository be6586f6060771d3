"""PyTorch port vs JAX package: the material-point simulators and the
gradient-based calibration.

Histories of the stress-driven and the strain-driven (triaxial) integrators
agree at 1e-12 of max|ref|; a short ``calibrate`` fit walks the same loss
history (1e-8 relative) to the same parameters (1e-6), through the
closed-form creep model of calibrate_creep.py and through the Mohr-Coulomb
triaxial twin of calibrate_triaxial.py, whose constructor the gradient
passes through.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import safeincave_tpu as sc
import safeincave_torch as st
import torch_port_configs as cfg

torch.set_num_threads(1)


def _close(got, want, tol, what=""):
    got, want = cfg.as_np(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=tol * max(np.abs(want).max(), 1e-300))


def _ones(pkg, n):
    return torch.ones(n, dtype=torch.float64) if pkg is st else jnp.ones(n)


def test_exports():
    for name in ("MaterialPointSimulator", "TriaxialSimulator", "calibrate"):
        assert hasattr(st, name) and name in st.__all__
    from safeincave_torch.matpoint import apply66_rows
    M = torch.arange(72, dtype=torch.float64).reshape(2, 6, 6)
    v = torch.arange(12, dtype=torch.float64).reshape(2, 6)
    assert torch.equal(apply66_rows(M, v), torch.einsum("nij,nj->ni", M, v))


@pytest.mark.parametrize("material", ["bench", "munson_dawson"])
def test_stress_driven_histories(material):
    """A staged triaxial stress path at three points with different
    confinements, through every mechanism with an internal variable."""
    n = 3
    times = np.linspace(0.0, 24 * cfg.HOUR, 13)
    conf = np.array([-4e6, -8e6, -12e6])
    axial = -14e6 - 6e6 * np.sin(np.pi * times / times[-1])
    hist = np.zeros((len(times), n, 3, 3))
    hist[:, :, 0, 0] = hist[:, :, 1, 1] = conf[None, :]
    hist[:, :, 2, 2] = axial[:, None] + conf[None, :] / 4
    hist[:, :, 0, 1] = hist[:, :, 1, 0] = 0.5e6
    out = {}
    for pkg in (sc, st):
        if material == "bench":
            mat = cfg.bench_material(pkg, n, "cpu")
        else:
            one = np.ones(n)
            mat = pkg.Material(n, **cfg.on(pkg, "cpu"))
            mat.add_to_elastic(pkg.Spring(102e9 * one, 0.3 * one))
            kw = {k: v * one for k, v in
                  cfg.JSON_KINDS["MunsonDawsonCreep"].items() if k != "T"}
            mat.add_to_non_elastic(pkg.MunsonDawsonCreep(
                **kw, **cfg.on(pkg, "cpu")))
        sim = pkg.MaterialPointSimulator(mat, theta=0.5,
                                         Temp=310.0 * np.ones(n))
        out[pkg] = (sim.run(hist, times), mat)
    rp, rj = out[st][0], out[sc][0]
    for key in ("eps_ne", "eps_e", "eps_total"):
        assert tuple(rp[key].shape) == (len(times), n, 3, 3)
        _close(rp[key], rj[key], 1e-12, key)
    names = [k for k in rj if isinstance(rj[k], dict)]
    assert names and names == [k for k in rp if isinstance(rp[k], dict)]
    for name in names:
        for key, want in rj[name].items():
            _close(rp[name][key], want, 1e-12, f"{name}.{key}")
    # the mechanisms keep the final state
    for e_p, e_j in zip(out[st][1].elems_ne, out[sc][1].elems_ne):
        _close(e_p.state["eps_old"], e_j.state["eps_old"], 1e-12,
               e_p.name)


def test_single_stress_tensor_broadcasts():
    """calibrate_creep.py's cross-check: a (T, 3, 3) history at one point."""
    sig = np.diag([-4e6, -4e6, -14e6])
    times = np.linspace(0.0, 48 * 3600.0, 9)
    res = {}
    for pkg in (sc, st):
        one = np.ones(1)
        mat = pkg.Material(1, **cfg.on(pkg, "cpu"))
        mat.add_to_elastic(pkg.Spring(102e9 * one, 0.3 * one))
        mat.add_to_non_elastic(pkg.DislocationCreep(
            1.9e-20 * one, 51600.0 * one, 3.0 * one, **cfg.on(pkg, "cpu")))
        res[pkg] = pkg.MaterialPointSimulator(mat).run(
            np.broadcast_to(sig, (len(times), 3, 3)), times)
    _close(res[st]["eps_ne"], res[sc]["eps_ne"], 1e-12)
    assert float(res[st]["eps_ne"][-1, 0, 2, 2]) < 0.0


MPa, DEG = 1e6, np.pi / 180.0
SR = np.array([-2.0 * MPa, -5.0 * MPa])
TIMES = np.linspace(0.0, 2000.0, 17)


def _twin(pkg, cohesion, friction):
    """calibrate_triaxial.py's ``run_twin`` for either package."""
    n = len(SR)
    one = _ones(pkg, n)
    dev = cfg.on(pkg, "cpu")
    mat = pkg.Material(n, **dev)
    mat.add_to_elastic(pkg.Spring(25e9 * np.ones(n), 0.3 * np.ones(n)))
    mat.add_to_non_elastic(pkg.MohrCoulombViscoplastic(
        mu_1=2e-5 * one, N_1=1.5 * one, cohesion=cohesion * one,
        friction_angle=friction * one, dilation_angle=10.0 * DEG * one,
        sigma_t=1.0 * one, **dev))
    sim = pkg.TriaxialSimulator(mat, theta=0.5)
    Ci = cfg.as_np(mat.C_inv)
    eps0 = (Ci[:, 2, 0] + Ci[:, 2, 1] + Ci[:, 2, 2]) * SR
    ez = eps0[None, :] - 1e-5 * TIMES[:, None]
    return sim.run_compression(SR, ez, TIMES), mat


def test_triaxial_compression_histories():
    rp, mat_p = _twin(st, 3.0, 30.0 * DEG)
    rj, _ = _twin(sc, 3.0, 30.0 * DEG)
    for key in ("sig_zz", "S_diff", "eps_axial", "eps_vol", "eps_ne"):
        assert tuple(rp[key].shape) == np.asarray(rj[key]).shape
        _close(rp[key], rj[key], 1e-12, key)
    # the weaker confinement yields: its differential stress flattens
    s = rp["S_diff"].numpy()
    assert s[-1, 0] < s[-1, 1] and s[-1, 0] - s[-2, 0] < 0.2 * (s[1, 0]
                                                                - s[0, 0])
    _close(mat_p.elems_ne[0].state["Fvp"],
           _twin(sc, 3.0, 30.0 * DEG)[1].elems_ne[0].state["Fvp"], 1e-12)


def test_mohr_coulomb_constructor_is_differentiable():
    """Any parameter that requires grad keeps the constructor in torch:
    the Drucker-Prager coefficients carry the history, with the values of
    the numpy branch, and the gradient of a rate is the finite
    difference."""
    n = 2
    one = torch.ones(n, dtype=torch.float64)
    c = torch.tensor(3.0, dtype=torch.float64, requires_grad=True)
    f = torch.tensor(30.0 * DEG, dtype=torch.float64, requires_grad=True)

    def build(c, f):
        return st.MohrCoulombViscoplastic(
            mu_1=2e-5 * one, N_1=1.5 * one, cohesion=c * one,
            friction_angle=f * one, dilation_angle=10.0 * DEG * one,
            sigma_t=1.0 * one, device="cpu")

    el = build(c, f)
    plain = build(c.detach(), f.detach())
    for k, v in plain.params.items():
        assert not v.requires_grad
        assert torch.equal(el.params[k].detach(), v), k
    assert el.params["k_F"].requires_grad
    assert el.params["alpha_F"].requires_grad
    sv = torch.tensor([[-2e6, -2e6, -30e6, 0.0, 0.0, 0.0]] * n,
                      dtype=torch.float64)
    T = 298.0 * one

    def rate_zz(c, f):
        el = build(c, f)
        return el.f_rate(el.state, sv, 0.0, T)["rate"][:, 2].sum()

    val = rate_zz(c, f)
    assert float(val) != 0.0
    gc, gf = torch.autograd.grad(val, (c, f))
    for g, (dc, df) in ((gc, (1e-6, 0.0)), (gf, (0.0, 1e-7))):
        fd = (rate_zz(c.detach() + dc, f.detach() + df)
              - rate_zz(c.detach() - dc, f.detach() - df)) / (2 * (dc + df))
        assert abs(float(g) - float(fd)) <= 1e-5 * abs(float(fd))


def test_calibrate_closed_form_creep():
    """calibrate_creep.py's fit, cut to 40 steps."""
    sig = np.diag([-4e6, -4e6, -14e6])
    times = np.linspace(0.0, 48 * 3600.0, 49)
    true = {"A": 1.9e-20, "Q": 51600.0, "n": 3.0}
    dev_zz = sig[2, 2] - np.trace(sig) / 3.0
    q = abs(sig[2, 2] - sig[0, 0])

    def model(xp, asarray):
        def axial(params):
            A_bar = (params["A"] * xp.exp(-asarray(true["Q"]) / 8.32 / 298.0)
                     * q ** (params["n"] - 1.0))
            return A_bar * dev_zz * asarray(times)
        return axial

    jax_model = model(jnp, jnp.asarray)
    torch_model = model(torch, lambda x: torch.as_tensor(
        x, dtype=torch.float64))
    rng = np.random.default_rng(0)
    observed = np.asarray(jax_model({k: jnp.asarray(v)
                                     for k, v in true.items()}))
    observed = observed * (1 + 0.01 * rng.standard_normal(observed.shape))
    kw = dict(params0={"A": 5e-20, "n": 2.5}, observed=observed, lr=0.05,
              steps=40, loss_scale=np.abs(observed).max())
    fit_j, hist_j = sc.calibrate(jax_model, **kw)
    fit_p, hist_p = st.calibrate(torch_model, device="cpu", **kw)
    assert len(hist_p) == len(hist_j) == 41
    np.testing.assert_allclose(hist_p, hist_j, rtol=1e-8)
    assert hist_p[-1] < 0.1 * hist_p[0]
    for k in fit_j:
        np.testing.assert_allclose(fit_p[k], np.asarray(fit_j[k]), rtol=1e-6)


def test_calibrate_through_the_triaxial_twin():
    """calibrate_triaxial.py's fit, cut to 3 steps on 17 time points: the
    gradient runs back through the Newton loop, the nested JVPs of the
    tangent and the Mohr-Coulomb constructor."""
    observed = np.asarray(_twin(sc, 3.0, 30.0 * DEG)[0]["S_diff"])
    kw = dict(params0={"cohesion": 1.5, "friction": 22.0 * DEG},
              observed=observed, lr=0.08, steps=3,
              loss_scale=float(np.abs(observed).max()))
    fit_j, hist_j = sc.calibrate(
        lambda p: _twin(sc, p["cohesion"], p["friction"])[0]["S_diff"], **kw)
    fit_p, hist_p = st.calibrate(
        lambda p: _twin(st, p["cohesion"], p["friction"])[0]["S_diff"],
        device="cpu", **kw)
    np.testing.assert_allclose(hist_p, hist_j, rtol=1e-8)
    assert hist_p[2] < hist_p[0]
    for k in fit_j:
        np.testing.assert_allclose(fit_p[k], np.asarray(fit_j[k]), rtol=1e-6)
