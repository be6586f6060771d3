"""The plain reference's constitutive models, in plain PyTorch.

A frozen copy of the mathematics of the program's mechanisms (SafeInCave's
formulation): tensorial Voigt storage [xx, yy, zz, xy, xz, yz], stresses in
Pa with tension positive, a theta scheme for the inelastic strain and, for
each mechanism, the flow Jacobian G = d(rate)/d(sigma) with the shear
columns doubled.  The Desai hardening linearization keeps SafeInCave's
literal forward differences (0.1 Pa stress probes, a 1e-4 relative alpha
probe, the base residue on the stored rate), since the published
trajectories depend on them; in float32 the probes are widened as they must
be to resolve anything at that precision.

Every function works in the dtype of the stress it is given, so the same
code is the float64 reference and, run in float32, the control.
"""
from __future__ import annotations

import math

import torch

W = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0)
ISO = (1.0, 1.0, 1.0, 0.0, 0.0, 0.0)
MPA = 1e6
R_GAS = 8.32


def _const(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def apply66(M, v):
    return torch.einsum("eij,ej->ei", M, v)


def isotropic(E, nu):
    """(C, C_inv) (n, 6, 6) of Young's modulus and Poisson's ratio (n,)."""
    n = E.shape[0]
    a0 = E / ((1 + nu) * (1 - 2 * nu))
    C = torch.zeros(n, 6, 6, dtype=E.dtype, device=E.device)
    Ci = torch.zeros_like(C)
    for i in range(3):
        for j in range(3):
            C[:, i, j] = a0 * nu
            Ci[:, i, j] = -nu / E
        C[:, i, i] = a0 * (1 - nu)
        Ci[:, i, i] = 1.0 / E
        C[:, i + 3, i + 3] = a0 * (1 - 2 * nu)
        Ci[:, i + 3, i + 3] = (1 + nu) / E
    return C, Ci


def flow_jacobian(rate_fn, sv):
    """d rate / d sigma (E, 6, 6) by one forward-mode pass over the six
    unit tangents stacked along the element axis; shear columns doubled."""
    E = sv.shape[0]
    t = torch.eye(6, dtype=sv.dtype, device=sv.device)
    t = t[:, None, :].expand(6, E, 6).reshape(6 * E, 6)
    _, jv = torch.func.jvp(rate_fn, (sv.repeat(6, 1),), (t,))
    return jv.reshape(6, E, 6).permute(1, 2, 0) * _const(W, sv)


def _dev(s):
    return s - (s[:, :3].sum(1) / 3.0)[:, None] * _const(ISO, s)


def _norm(s):
    q = s * s
    return torch.sqrt(q[:, :3].sum(1) + 2.0 * q[:, 3:].sum(1))


class Mechanism:
    """State: eps_old, rate, rate_old, eps_k (E, 6), G (E, 6, 6), B (E, 6),
    plus a mechanism's own internal variables."""

    def __init__(self, n, dtype, device, params):
        self.p = {k: torch.as_tensor(v, dtype=torch.float64).to(
                  dtype=dtype, device=device).expand(n).clone()
                  for k, v in params.items()}
        z = torch.zeros(n, 6, dtype=dtype, device=device)
        self.s = {"eps_old": z, "rate": z, "rate_old": z, "eps_k": z,
                  "G": torch.zeros(n, 6, 6, dtype=dtype, device=device),
                  "B": z}

    def repeat6(self):
        return {k: v.repeat(6) for k, v in self.p.items()}

    def rate_of(self, sv, p=None):
        raise NotImplementedError

    def update_rate(self, sv, phi1, T):
        self.s["rate"] = self.rate_of(sv, T)

    def tangent(self, sv, T, dt, theta):
        p6 = self.repeat6()
        T6 = T.repeat(6)
        self.s["G"] = flow_jacobian(lambda x: self.rate_of(x, T6, p6), sv)
        self.s["B"] = torch.zeros_like(self.s["B"])

    def predictor(self, phi1, phi2):
        s = self.s
        s["eps_k"] = s["eps_old"] + phi1 * s["rate_old"] + phi2 * s["rate"]

    def increment(self, sv, sv_k, dt):
        pass

    def commit(self, sv, sv_k, phi2):
        s = self.s
        s["rate_old"] = s["rate"]
        s["eps_old"] = (s["eps_k"] + phi2 * apply66(s["G"], sv - sv_k)
                        - phi2 * s["B"])

    def snapshot(self):
        return dict(self.s)


class KelvinVoigt(Mechanism):
    """rate = G : (sigma - C1 : (eps_old + phi1 rate_old)),
    G = (eta I + phi2 C1)^-1."""

    def __init__(self, n, dtype, device, eta, E, nu):
        super().__init__(n, dtype, device, {"eta": eta, "E": E, "nu": nu})
        self.C1, _ = isotropic(self.p["E"], self.p["nu"])

    def update_rate(self, sv, phi1, T):
        s = self.s
        hist = s["eps_old"] + phi1 * s["rate_old"]
        s["rate"] = apply66(s["G"], sv - apply66(self.C1, hist))

    def tangent(self, sv, T, dt, theta):
        eye = torch.eye(6, dtype=sv.dtype, device=sv.device)
        phi2 = dt * (1 - theta)
        self.s["G"] = torch.linalg.inv(self.p["eta"][:, None, None] * eye
                                       + phi2 * self.C1)
        self.s["B"] = torch.zeros_like(self.s["B"])


class DislocationCreep(Mechanism):
    """rate = A exp(-Q / (R T)) q^(n-1) dev(sigma), q the von Mises stress
    with a floor inside the square root."""

    def __init__(self, n, dtype, device, A, Q, n_exp):
        super().__init__(n, dtype, device, {"A": A, "Q": Q, "n": n_exp})

    def rate_of(self, sv, T, p=None):
        p = p or self.p
        floor = 1e-30 if sv.dtype == torch.float64 else 1e-15
        d = sv
        arg = 0.5 * ((d[:, 0] - d[:, 1]) ** 2 + (d[:, 0] - d[:, 2]) ** 2
                     + (d[:, 1] - d[:, 2]) ** 2
                     + 6.0 * (d[:, 3] ** 2 + d[:, 4] ** 2 + d[:, 5] ** 2))
        q = torch.sqrt(torch.clamp(arg, min=floor * floor))
        coef = torch.exp(torch.log(p["A"]) - p["Q"] / R_GAS / T
                         + (p["n"] - 1.0) * torch.log(q))
        return coef[:, None] * _dev(sv)


def _invariants(s):
    sxx, syy, szz, sxy, sxz, syz = s.unbind(-1)
    I1 = sxx + syy + szz
    I2 = sxx * syy + syy * szz + sxx * szz - sxy ** 2 - syz ** 2 - sxz ** 2
    I3 = (sxx * syy * szz + 2 * sxy * syz * sxz
          - szz * sxy ** 2 - sxx * syz ** 2 - syy * sxz ** 2)
    return I1, I2, I3, I1 ** 2 / 3.0 - I2, \
        (2.0 / 27.0) * I1 ** 3 - I1 * I2 / 3.0 + I3


class Desai(Mechanism):
    """Perzyna viscoplasticity on Desai's yield function, with the
    hardening variable alpha driven by the accumulated viscoplastic strain
    qsi, stresses compression-positive in MPa inside the model."""

    J2_MIN, F2_MIN, H_MIN, ALPHA_MIN = 1e-6, 1e-6, 1e-6, 1e-10

    def __init__(self, n_elems, dtype, device, **params):
        super().__init__(n_elems, dtype, device, params)
        z = torch.zeros(n_elems, dtype=dtype, device=device)
        self.s.update(alpha=self.p["alpha_0"].clone(), qsi=z, qsi_old=z,
                      r=z, h=torch.ones_like(z),
                      P=torch.zeros(n_elems, 6, dtype=dtype, device=device),
                      h_small=torch.zeros(n_elems, dtype=torch.bool,
                                          device=device))

    def flow(self, sv, alpha, p):
        s = -sv / MPA
        sxx, syy, szz, sxy, sxz, syz = s.unbind(-1)
        I1, I2, I3, J2, J3 = _invariants(s)
        low = J2 <= self.J2_MIN
        J2s = torch.clamp(J2, min=self.J2_MIN)
        Sr = torch.where(low, 0.0, -(J3 * math.sqrt(27.0))
                         / (2.0 * J2s ** 1.5))
        I1s = I1 + p["sigma_t"]
        I1c = torch.clamp(I1s, min=1e-12)
        n, m, beta, beta_1 = p["n"], p["m"], p["beta"], p["beta_1"]
        ex = torch.exp(torch.clamp(beta_1 * I1s, -50.0, 50.0))
        F2 = ex - beta * Sr
        f2_neg = F2 < self.F2_MIN
        F2 = torch.clamp(F2, min=self.F2_MIN)
        Fvp = J2s + (alpha * I1c ** n - p["gamma"] * I1s ** 2) * F2 ** m
        F1 = -alpha * I1c ** n + p["gamma"] * I1s ** 2
        dF_dI1 = -((2 * p["gamma"] * I1s - n * alpha * I1c ** (n - 1))
                   * F2 ** m + F1 * beta_1 * m * ex * F2 ** (m - 1))
        dF_dJ2 = 1 - F1 * m * F2 ** (m - 1) * (
            -(3 * beta * J3 * math.sqrt(27.0)) / (4 * J2s ** 2.5))
        dF_dJ3 = -m * F1 * beta * math.sqrt(27.0) * F2 ** (m - 1) / (
            2 * J2s ** 1.5)
        dI1 = s.new_tensor(ISO).expand_as(s)
        dI2 = torch.stack([syy + szz, sxx + szz, sxx + syy,
                           -2 * sxy, -2 * sxz, -2 * syz], -1)
        dI3 = torch.stack([syy * szz - syz ** 2, sxx * szz - sxz ** 2,
                           sxx * syy - sxy ** 2, 2 * (sxz * syz - szz * sxy),
                           2 * (sxy * syz - syy * sxz),
                           2 * (sxz * sxy - sxx * syz)], -1)
        dJ2 = (2.0 / 3.0) * I1[:, None] * dI1 - dI2
        dJ3 = (((2.0 / 9.0) * I1 ** 2 - I2 / 3.0)[:, None] * dI1
               - (I1 / 3.0)[:, None] * dI2 + dI3)
        dQ = (dF_dI1[:, None] * dI1 + dF_dJ2[:, None] * dJ2
              + dF_dJ3[:, None] * dJ3)
        tension = I1s <= 0.0
        kill = low | f2_neg | (alpha <= 0.01 * p["alpha_0"]) | tension
        dQ = torch.where(kill[:, None], 0.0, dQ)
        yielding = (Fvp > 0) & ~tension
        lam = torch.where(yielding, p["mu_1"] * torch.where(
            yielding, Fvp, 1.0) ** p["N_1"], 0.0)
        return -dQ * lam[:, None]

    def rate_of(self, sv, T, p=None, alpha=None):
        return self.flow(sv, self.s["alpha"] if alpha is None else alpha,
                         p or self.p)

    def residue(self, rate, alpha, dt):
        p = self.p
        qsi = self.s["qsi_old"] + _norm(rate) * dt
        return alpha - p["a_1"] / (((p["a_1"] / p["alpha_0"])
                                    ** (1.0 / p["eta"]) + qsi) ** p["eta"])

    def tangent(self, sv, T, dt, theta):
        s, p = self.s, self.p
        f32 = sv.dtype == torch.float32
        alpha = s["alpha"]
        r = self.residue(s["rate"], alpha, dt)
        ea = (1e-2 if f32 else 1e-4) * alpha
        rate_a = self.flow(sv, alpha + ea, p)
        h = (self.residue(rate_a, alpha + ea, dt) - r) / ea
        Q = (rate_a - s["rate"]) / ea[:, None]
        cols = []
        for k in range(6):
            es = 1e-3 * (1.0 + sv[:, k].abs()) if f32 else 1e-1
            probe = sv.clone()
            probe[:, k] += es
            cols.append((self.residue(self.flow(probe, alpha, p), alpha, dt)
                         - r) / es)
        P = torch.stack(cols, -1)
        s["qsi"] = s["qsi_old"] + _norm(self.flow(sv, alpha, p)) * dt
        small = h.abs() < self.H_MIN
        h = torch.where(small, 1.0, h)
        H = Q[:, :, None] * (P * _const(W, P))[:, None, :] / h[:, None, None]
        p6 = self.repeat6()
        E = flow_jacobian(lambda x: self.flow(x, alpha.repeat(6), p6), sv)
        s["G"] = E - torch.where(small[:, None, None], 0.0, H)
        s["B"] = torch.where(small[:, None], 0.0, (r / h)[:, None] * Q)
        s["P"] = torch.where(small[:, None], 0.0, P)
        s["r"], s["h"], s["h_small"] = r, h, small

    def increment(self, sv, sv_k, dt):
        s = self.s
        d = sv - sv_k
        delta = -(s["r"] + (s["P"] * _const(W, d) * d).sum(-1)) / s["h"]
        delta = torch.where(s["h_small"], 0.0, delta)
        s["alpha"] = torch.clamp(s["alpha"] + delta, min=self.ALPHA_MIN)

    def commit(self, sv, sv_k, phi2):
        self.s["qsi_old"] = self.s["qsi"]
        super().commit(sv, sv_k, phi2)


class MohrCoulomb(Mechanism):
    """Drucker-Prager circumscription of Mohr-Coulomb with a tension
    cut-off, non-associated flow through the dilation angle, Perzyna
    multiplier on the overstress in MPa."""

    def __init__(self, n, dtype, device, mu_1, N_1, cohesion, friction_angle,
                 dilation_angle, sigma_t):
        sq3 = math.sqrt(3.0)
        f64 = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa
        sp, cp = torch.sin(f64(friction_angle)), torch.cos(f64(friction_angle))
        sd = torch.sin(f64(dilation_angle))
        cohesion = f64(cohesion)
        super().__init__(n, dtype, device, {
            "mu_1": mu_1, "N_1": N_1, "sigma_t": sigma_t,
            "alpha_F": 2.0 * sp / (sq3 * (3.0 - sp)),
            "k_F": 6.0 * cohesion * cp / (sq3 * (3.0 - sp)),
            "alpha_Q": 2.0 * sd / (sq3 * (3.0 - sd))})

    def rate_of(self, sv, T, p=None):
        p = p or self.p
        s = -sv / MPA
        sxx, syy, szz, sxy, sxz, syz = s.unbind(-1)
        I1 = sxx + syy + szz
        I2 = (sxx * syy + syy * szz + sxx * szz - sxy ** 2 - syz ** 2
              - sxz ** 2)
        J2 = torch.clamp(I1 ** 2 / 3.0 - I2, min=1e-20)
        dJ2 = torch.stack([(2. / 3.) * I1 - (syy + szz),
                           (2. / 3.) * I1 - (sxx + szz),
                           (2. / 3.) * I1 - (sxx + syy),
                           2 * sxy, 2 * sxz, 2 * syz], -1)
        iso = s.new_tensor(ISO).expand_as(s)
        dQ = dJ2 / (2.0 * torch.sqrt(J2))[:, None] - p["alpha_Q"][:, None] * iso
        F_shear = torch.sqrt(J2) - p["alpha_F"] * I1 - p["k_F"]
        F_tension = -I1 / 3.0 - p["sigma_t"]
        Fvp = torch.maximum(F_shear, F_tension)
        dQ = torch.where((F_tension > F_shear)[:, None], -iso / 3.0, dQ)
        lam = torch.where(Fvp > 0, p["mu_1"] * torch.where(
            Fvp > 0, Fvp, 1.0) ** p["N_1"], 0.0)
        return -dQ * lam[:, None]


KINDS = {"kelvin_voigt": KelvinVoigt, "dislocation_creep": DislocationCreep,
         "desai": Desai, "mohr_coulomb": MohrCoulomb}
