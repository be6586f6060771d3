"""Kelvin-Voigt viscoelasticity and the creep mechanisms (dislocation,
pressure solution, Munson-Dawson).

Port of ``safeincave_tpu/materials/creep.py``.  Rates are batched functions
of the tensorial-Voigt stress (SafeInCave sign convention, Pa); tangents are
exact forward-mode derivatives.
"""
from __future__ import annotations

import torch

from ..linalg import inv6x6_fast
from ..utils import iso6, voigt_to_tensor, voigt_weight
from .base import F64, NonElasticElement, apply66
from .elastic import isotropic_C

_R_GAS = 8.32  # gas constant value of the reference model


def _dev6(sv6):
    mean = (sv6[:, 0] + sv6[:, 1] + sv6[:, 2]) / 3.0
    return sv6 - mean[:, None] * iso6(sv6)


def _von_mises6_floor(sv6, floor):
    """Von Mises with the floor inside the sqrt, so the derivative stays
    finite at zero deviatoric stress.  In float32 the squared floor must stay
    above the underflow threshold (1e-30 squared flushes to 0), else the
    derivative there is NaN."""
    if sv6.dtype == torch.float32:
        floor = max(floor, 1e-15)
    xx, yy, zz, xy, xz, yz = sv6.unbind(-1)
    arg = 0.5 * ((xx - yy) ** 2 + (xx - zz) ** 2 + (yy - zz) ** 2
                 + 6.0 * (xy ** 2 + xz ** 2 + yz ** 2))
    return torch.sqrt(torch.clamp(arg, min=floor * floor))


class DislocationCreep(NonElasticElement):
    """Power-law creep: rate = A exp(-Q/RT) q^(n-1) s."""

    def __init__(self, A, Q, n, name: str = "creep", device=None):
        super().__init__(len(A), name, device)
        self.params = {"A": self._tensor(A), "Q": self._tensor(Q),
                       "n": self._tensor(n)}
        self.R = _R_GAS

    def _rate(self, sv6, isv, T, p):
        dev = _dev6(sv6)
        # the floor keeps d(q^(n-1))/d(sigma) finite at zero deviatoric
        # stress, far below any physical stress
        q = _von_mises6_floor(sv6, 1e-30)
        # log space: q**(n-1) alone overflows for large n at cavern stresses
        A_bar = torch.exp(torch.log(p["A"]) - p["Q"] / _R_GAS / T
                          + (p["n"] - 1.0) * torch.log(q))
        return A_bar[:, None] * dev


class PressureSolutionCreep(NonElasticElement):
    """Linear creep: rate = (A / (d^3 T)) exp(-Q/RT) s."""

    def __init__(self, A, d, Q, name: str = "creep", device=None):
        super().__init__(len(A), name, device)
        self.params = {"A": self._tensor(A), "d": self._tensor(d),
                       "Q": self._tensor(Q)}
        self.R = _R_GAS

    def _rate(self, sv6, isv, T, p):
        A_bar = (p["A"] / p["d"] ** 3 / T) * torch.exp(-p["Q"] / _R_GAS / T)
        return A_bar[:, None] * _dev6(sv6)


class Viscoelastic(NonElasticElement):
    """Kelvin-Voigt viscoelasticity.

    rate = G : (sigma - C1 : (eps_old + phi1 rate_old)), with the closed
    form tangent G = (eta I + phi2 C1)^-1.
    """

    def __init__(self, eta, E, nu, name: str = "kelvin_voigt", device=None):
        super().__init__(len(E), name, device)
        self.params = {"eta": self._tensor(eta), "E": self._tensor(E),
                       "nu": self._tensor(nu)}
        self.C1 = torch.as_tensor(isotropic_C(E, nu), device=self.device)
        self._C1_32 = self.C1.to(torch.float32)

    def _C1_for(self, dtype):
        return self._C1_32 if dtype == torch.float32 else self.C1

    def f_tangent(self, state, sv6, T, dt, theta):
        phi2 = dt * (1 - theta)
        eye = torch.eye(6, dtype=sv6.dtype, device=sv6.device)
        mat = (self._p(sv6.dtype)["eta"][:, None, None] * eye
               + phi2 * self._C1_for(sv6.dtype))
        E_op, _ = inv6x6_fast(mat)
        new = dict(state)
        new["G"] = E_op
        new["B"] = torch.zeros_like(state["B"])
        return new

    def f_rate_value(self, state, sv6, phi1, T):
        hist = state["eps_old"] + phi1 * state["rate_old"]
        drive = sv6 - apply66(self._C1_for(sv6.dtype), hist)
        return apply66(state["G"], drive)


class MunsonDawsonCreep(NonElasticElement):
    """Munson-Dawson transient + steady-state creep with the internal
    variable zeta.

    The zeta update is linearized into the global iteration with the
    (r, h, Q, P) consistent-tangent pattern of ViscoplasticDesai, here with
    exact derivatives.  Stress enters in Pa, with neither MPa scaling nor a
    sign flip.
    """

    H_MIN = 1e-12  # ill-conditioning guard on h = dr/dzeta

    def __init__(self, A, Q, n, K0, c, m, alpha_w, beta_w, delta, mu,
                 name: str = "creep_munson_dawson", device=None):
        super().__init__(len(A), name, device)
        t = self._tensor
        self.params = {
            "A": t(A), "Q": t(Q), "n": t(n), "K0": t(K0), "c": t(c),
            "m": t(m), "alpha_w": t(alpha_w), "beta_w": t(beta_w),
            "delta": t(delta), "mu": t(mu),
        }
        self.R = _R_GAS
        z = self._zeros(self.n_elems)
        ones = torch.ones_like(z)
        self.state.update({
            "zeta": z, "zeta_old": z, "F": ones, "eps_t_star": ones, "r": z,
            "h": ones, "P": self._zeros(self.n_elems, 6),
            "h_small": torch.zeros_like(z, dtype=torch.bool),
        })

    # -- element-wise physics (batched over elements) --------------------- #
    @staticmethod
    def _md_fields(sv6, zeta, T, p):
        """(deviator, floored von Mises, steady-state rate, transient strain
        limit, transient function F)."""
        dev = _dev6(sv6)
        # 1 Pa floor, inside the sqrt for a finite derivative
        sigma_safe = _von_mises6_floor(sv6, 1.0)
        mu_safe = torch.clamp(p["mu"], min=1.0)

        # log space: sigma^n alone overflows for large n at cavern stresses
        epsdot_ss = torch.exp(torch.log(p["A"]) - p["Q"] / (_R_GAS * T)
                              + p["n"] * torch.log(sigma_safe))

        ratio = torch.clamp(sigma_safe / mu_safe, min=1e-30)
        eps_t_star = p["K0"] * torch.exp(p["c"] * T) * ratio ** p["m"]
        # float32: 1e-50 flushes to zero and zeta / eps_t_star would blow up
        e_floor = 1e-50 if sv6.dtype != torch.float32 else 1e-30
        eps_t_star = torch.clamp(eps_t_star, min=e_floor)

        delta_cap = p["alpha_w"] + p["beta_w"] * torch.log10(ratio)
        r_arg2 = (1.0 - zeta / eps_t_star) ** 2
        exp_hard = torch.clamp(delta_cap * r_arg2, -50.0, 50.0)
        exp_recov = torch.clamp(-p["delta"] * r_arg2, -50.0, 50.0)
        F = torch.where(zeta <= eps_t_star, torch.exp(exp_hard),
                        torch.exp(exp_recov))
        return dev, sigma_safe, epsdot_ss, eps_t_star, F

    @staticmethod
    def _rate_static(sv6, zeta, T, p):
        dev, sigma_safe, epsdot_ss, _, F = MunsonDawsonCreep._md_fields(
            sv6, zeta, T, p)
        return ((F * epsdot_ss) * (1.5 / sigma_safe))[:, None] * dev

    @staticmethod
    def _residue(sv6, zeta, zeta_old, T, dt, p):
        """Backward-Euler residue r = zeta - zeta_old - (F - 1) epsdot_ss
        dt."""
        _, _, epsdot_ss, _, F = MunsonDawsonCreep._md_fields(sv6, zeta, T, p)
        return zeta - zeta_old - (F - 1.0) * epsdot_ss * dt

    # -- element protocol -------------------------------------------------- #
    def _isv_slice(self, state):
        return {"zeta": state["zeta"]}

    def _rate(self, sv6, isv, T, p):
        return self._rate_static(sv6, isv["zeta"], T, p)

    def f_rate(self, state, sv6, phi1, T):
        dev, sigma_safe, epsdot_ss, eps_t_star, F = self._md_fields(
            sv6, state["zeta"], T, self._p(sv6.dtype))
        new = dict(state)
        new["rate"] = ((F * epsdot_ss) * (1.5 / sigma_safe))[:, None] * dev
        new["eps_t_star"] = eps_t_star
        new["F"] = F
        return new

    def f_tangent(self, state, sv6, T, dt, theta):
        """Exact (r, h, Q, P) consistent tangent.

        One forward-mode JVP gives every derivative: the six unit stress
        tangents and the unit zeta tangent are stacked along the element
        axis, and the rate and the residue are differentiated together
        (E = d rate/d sigma, P = d r/d sigma, Q = d rate/d zeta,
        h = d r/d zeta)."""
        n = sv6.shape[0]
        zeta, zeta_old = state["zeta"], state["zeta_old"]
        rep = lambda x: x.repeat(7)  # noqa: E731
        p7 = {k: rep(v) for k, v in self._p(sv6.dtype).items()}
        T7, zo7 = rep(T), rep(zeta_old)
        tangent = torch.eye(7, dtype=sv6.dtype, device=sv6.device)
        tangent = tangent[:, None, :].expand(7, n, 7).reshape(7 * n, 7)

        def rate_and_residue(s, z):
            dev, sigma_safe, epsdot_ss, _, F = self._md_fields(s, z, T7, p7)
            rate = ((F * epsdot_ss) * (1.5 / sigma_safe))[:, None] * dev
            return rate, z - zo7 - (F - 1.0) * epsdot_ss * dt

        (_, res), (d_rate, d_res) = torch.func.jvp(
            rate_and_residue, (sv6.repeat(7, 1), rep(zeta)),
            (tangent[:, :6].contiguous(), tangent[:, 6].contiguous()))
        r = res[:n]
        d_rate = d_rate.reshape(7, n, 6)
        d_res = d_res.reshape(7, n)
        jac = d_rate[:6].permute(1, 2, 0)            # [e, i, k] = d r_i/d s_k
        E = jac * voigt_weight(jac)
        Q = d_rate[6]
        P = d_res[:6].T
        h = d_res[6]

        h_small = h.abs() < self.H_MIN
        h = torch.where(h_small, 1.0, h)
        B = (r / h)[:, None] * Q

        # H = Q (outer) P in tensorial Voigt with doubled shear columns
        H = Q[:, :, None] * (P * voigt_weight(P))[:, None, :]
        H_over_h = H / h[:, None, None]

        B = torch.where(h_small[:, None], 0.0, B)
        P = torch.where(h_small[:, None], 0.0, P)
        H_over_h = torch.where(h_small[:, None, None], 0.0, H_over_h)

        new = dict(state)
        new.update(G=E - H_over_h, B=B, r=r, h=h, P=P, h_small=h_small)
        return new

    def f_increment_isv(self, state, sv6, sv6_k, dt):
        """delta_zeta = -(r + P:(sigma - sigma_k)) / h, zeta kept >= 0."""
        dsig = sv6 - sv6_k
        pd = (state["P"] * voigt_weight(dsig) * dsig).sum(-1)
        delta = -(state["r"] + pd) / state["h"]
        delta = torch.where(state["h_small"], 0.0, delta)
        new = dict(state)
        new["zeta"] = torch.clamp(state["zeta"] + delta, min=0.0)
        return new

    def f_commit_isv(self, state):
        new = dict(state)
        new["zeta_old"] = state["zeta"]
        return new

    # -- reference-style views --------------------------------------------- #
    @property
    def zeta(self):
        return self.state["zeta"]

    @property
    def zeta_old(self):
        return self.state["zeta_old"]

    @property
    def F(self):
        return self.state["F"]

    @property
    def P(self):
        return voigt_to_tensor(self.state["P"])

    @property
    def r(self):
        return self.state["r"]

    @property
    def h(self):
        return self.state["h"]

    def compute_residue(self, stress, zeta, Temp, dt):
        return self._residue(self._sv(stress),
                             torch.as_tensor(zeta, dtype=F64).to(self.device),
                             self.state["zeta_old"], self._T(Temp), dt,
                             self.params)
