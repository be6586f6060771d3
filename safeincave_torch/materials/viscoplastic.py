"""Viscoplastic elements: Desai, Mohr-Coulomb (Drucker-Prager) and
Matsuoka-Nakai (port of safeincave_tpu/materials/viscoplastic.py).

All three use compression-positive, MPa-scaled stresses inside the model and
a Perzyna overstress multiplier.  Mohr-Coulomb and Matsuoka-Nakai are
perfectly plastic (no internal variable) with the Drucker-Prager
non-associated flow direction, and their tangent is the exact flow Jacobian.

The Desai hardening linearization (r, h, Q, P) is the
reference's *literal* forward differences, reproduced exactly (stale-rate
base, 1e-4 alpha probe, 0.1 Pa stress probes): the published trajectories
depend on them.  Only the flow Jacobian E is exact.  All guards (J2 floor,
F2 clamp, softening cut-off, |h| ~ 0, alpha positivity) are preserved.
"""
from __future__ import annotations

import numpy as np
import torch

from ..linalg import eigvalsh3x3
from ..utils import MPa, iso6, norm_voigt, voigt_to_tensor, voigt_weight
from .base import NonElasticElement

_SQRT27 = float(np.sqrt(27.0))


def _cp_mpa(sv6):
    """SafeInCave stress (Pa, tension+) -> compression-positive MPa."""
    return -sv6 / MPa


def _invariants_cp(s):
    """I1, I2, I3, J2, J3 from compression-positive (E, 6) components."""
    sxx, syy, szz, sxy, sxz, syz = s.unbind(-1)
    I1 = sxx + syy + szz
    I2 = sxx * syy + syy * szz + sxx * szz - sxy ** 2 - syz ** 2 - sxz ** 2
    I3 = (sxx * syy * szz + 2 * sxy * syz * sxz
          - szz * sxy ** 2 - sxx * syz ** 2 - syy * sxz ** 2)
    J2 = I1 ** 2 / 3.0 - I2
    J3 = (2.0 / 27.0) * I1 ** 3 - (1.0 / 3.0) * I1 * I2 + I3
    return I1, I2, I3, J2, J3


def _clip50(x):
    return torch.clamp(x, -50.0, 50.0)


class ViscoplasticDesai(NonElasticElement):
    """Perzyna viscoplasticity with hardening variable alpha."""

    F_0 = 1.0
    J2_MIN = 1e-6       # MPa^2 floor
    F2_MIN = 1e-6       # clamp on F2
    H_MIN = 1e-6        # |h| guard
    ALPHA_MIN = 1e-10   # positivity clamp on alpha
    EPS_STRESS = 1e-1   # stress probe (Pa)
    EPS_ALPHA = 1e-4    # relative alpha probe

    def __init__(self, mu_1, N_1, a_1, eta, n, beta_1, beta, m, gamma,
                 sigma_t, alpha_0, name: str = "desai", device=None):
        super().__init__(len(mu_1), name, device)
        t = self._tensor
        self.params = {
            "mu_1": t(mu_1), "N_1": t(N_1), "a_1": t(a_1), "eta": t(eta),
            "n": t(n), "beta_1": t(beta_1), "beta": t(beta), "m": t(m),
            "gamma": t(gamma), "sigma_t": t(sigma_t), "alpha_0": t(alpha_0),
        }
        z = self._zeros(self.n_elems)
        self.state.update({
            "alpha": self.params["alpha_0"].clone(),
            "qsi": z, "qsi_old": z, "Fvp": z, "r": z,
            "h": torch.ones_like(z),
            "P": self._zeros(self.n_elems, 6),
            "h_small": torch.zeros_like(z, dtype=torch.bool),
        })

    # -- element-wise physics (batched over elements) --------------------- #
    @staticmethod
    def _Fvp(alpha, I1s, J2s, Sr, p):
        """Yield function.  ``I1s <= 0`` is outside the model's domain: the
        power is taken of a clamped base and callers kill the flow there."""
        I1c = torch.clamp(I1s, min=1e-12)
        F1 = alpha * I1c ** p["n"] - p["gamma"] * I1s ** 2
        F2 = torch.exp(_clip50(p["beta_1"] * I1s)) - p["beta"] * Sr
        F2 = torch.clamp(F2, min=ViscoplasticDesai.F2_MIN)
        return J2s + F1 * F2 ** p["m"]

    @staticmethod
    def _rate_static(sv6, alpha, p):
        """(viscoplastic strain rate (E, 6), Fvp (E,))."""
        cls = ViscoplasticDesai
        s = _cp_mpa(sv6)
        sxx, syy, szz, sxy, sxz, syz = s.unbind(-1)
        I1, I2, I3, J2, J3 = _invariants_cp(s)

        j2_low = J2 <= cls.J2_MIN
        J2s = torch.clamp(J2, min=cls.J2_MIN)
        Sr = -(J3 * _SQRT27) / (2.0 * J2s ** 1.5)
        Sr = torch.where(j2_low, 0.0, Sr)

        I1s = I1 + p["sigma_t"]
        Fvp = cls._Fvp(alpha, I1s, J2s, Sr, p)

        tension = I1s <= 0.0
        I1c = torch.clamp(I1s, min=1e-12)

        # flow direction dF/dsigma via the (I1, J2, J3) chain rule
        n, m, beta, beta_1 = p["n"], p["m"], p["beta"], p["beta_1"]
        F1 = -alpha * I1c ** n + p["gamma"] * I1s ** 2
        F2 = torch.exp(_clip50(beta_1 * I1s)) - beta * Sr
        f2_neg = F2 < cls.F2_MIN
        F2 = torch.clamp(F2, min=cls.F2_MIN)

        dF1_dI1 = 2 * p["gamma"] * I1s - n * alpha * I1c ** (n - 1)
        dF2m_dI1 = (beta_1 * m * torch.exp(_clip50(beta_1 * I1s))
                    * F2 ** (m - 1))
        dF_dI1 = -(dF1_dI1 * F2 ** m + F1 * dF2m_dI1)

        dF2_dJ2 = -(3 * beta * J3 * _SQRT27) / (4 * J2s ** 2.5)
        dF_dJ2 = 1 - F1 * m * F2 ** (m - 1) * dF2_dJ2
        dF_dJ3 = -m * F1 * beta * _SQRT27 * F2 ** (m - 1) / (2 * J2s ** 1.5)

        dI2 = torch.stack([syy + szz, sxx + szz, sxx + syy,
                           -2 * sxy, -2 * sxz, -2 * syz], dim=-1)
        dI3 = torch.stack([syy * szz - syz ** 2,
                           sxx * szz - sxz ** 2,
                           sxx * syy - sxy ** 2,
                           2 * (sxz * syz - szz * sxy),
                           2 * (sxy * syz - syy * sxz),
                           2 * (sxz * sxy - sxx * syz)], dim=-1)
        dI1 = iso6(s)

        col = lambda x: x[:, None]  # noqa: E731
        dJ2 = col((2.0 / 3.0) * I1) * dI1 - dI2
        dJ3_dI1 = (2.0 / 9.0) * I1 ** 2 - (1.0 / 3.0) * I2
        dJ3_dI2 = -(1.0 / 3.0) * I1
        dJ3 = col(dJ3_dI1) * dI1 + col(dJ3_dI2) * dI2 + dI3

        dQdS = col(dF_dI1) * dI1 + col(dF_dJ2) * dJ2 + col(dF_dJ3) * dJ3

        # zero flow where J2 ~ 0, F2 was negative, alpha fully softened, or
        # net tension beyond the tensile shift
        softened = alpha <= 0.01 * p["alpha_0"]
        kill = j2_low | f2_neg | softened | tension
        dQdS = torch.where(col(kill), 0.0, dQdS)

        # Perzyna multiplier with a NaN-safe power
        yielding = (Fvp > 0) & ~tension
        Fvp_safe = torch.where(yielding, Fvp, 1.0)
        lmbda = torch.where(
            yielding, p["mu_1"] * (Fvp_safe / cls.F_0) ** p["N_1"], 0.0)
        return -dQdS * col(lmbda), Fvp

    @staticmethod
    def _residue(rate6, alpha, qsi_old, dt, p):
        """Hardening residue r(alpha) and the implied qsi."""
        qsi = qsi_old + norm_voigt(rate6) * dt
        r = alpha - p["a_1"] / (((p["a_1"] / p["alpha_0"])
                                 ** (1.0 / p["eta"]) + qsi) ** p["eta"])
        return r, qsi

    # -- element protocol -------------------------------------------------- #
    def _isv_slice(self, state):
        return {"alpha": state["alpha"]}

    def _rate(self, sv6, isv, T, p):
        return self._rate_static(sv6, isv["alpha"], p)[0]

    def f_rate(self, state, sv6, phi1, T):
        new = dict(state)
        new["rate"], new["Fvp"] = self._rate_static(sv6, state["alpha"],
                                                     self._p(sv6.dtype))
        return new

    def f_tangent(self, state, sv6, T, dt, theta):
        """(r, h, Q, P) hardening linearization by the reference's literal
        forward differences: the base residue uses the *stored* rate while
        the probes recompute the rate, and the trajectories depend on it.

        In float32 (the f32 fixed-point sweep) the probes fall below the
        format's resolution (0.1 Pa on ~1e7 Pa is a 1e-8 relative nudge), so
        they are widened; the probes shape only the iteration path, and the
        f64 iterations with the reference probes decide convergence."""
        p = self._p(sv6.dtype)
        f32 = sv6.dtype == torch.float32
        alpha = state["alpha"]
        qsi_old = state["qsi_old"]

        def rate(sv, a):
            return self._rate_static(sv, a, p)[0]

        r, _ = self._residue(state["rate"], alpha, qsi_old, dt, p)

        eps_a = (1e-2 if f32 else self.EPS_ALPHA) * alpha
        rate_a = rate(sv6, alpha + eps_a)
        r_a, _ = self._residue(rate_a, alpha + eps_a, qsi_old, dt, p)
        h = (r_a - r) / eps_a
        Q = (rate_a - state["rate"]) / eps_a[:, None]

        P_cols = []
        for k in range(6):
            eps_s = (1e-3 * (1.0 + sv6[:, k].abs()) if f32
                     else self.EPS_STRESS)
            sv_p = sv6.clone()
            sv_p[:, k] += eps_s
            r_p, _ = self._residue(rate(sv_p, alpha), alpha, qsi_old, dt, p)
            P_cols.append((r_p - r) / eps_s)
        P = torch.stack(P_cols, dim=-1)

        # the committed qsi uses the fresh rate at the probe point
        qsi = qsi_old + norm_voigt(rate(sv6, alpha)) * dt

        h_small = h.abs() < self.H_MIN
        h = torch.where(h_small, 1.0, h)
        B = (r / h)[:, None] * Q

        H = Q[:, :, None] * (P * voigt_weight(P))[:, None, :]
        H_over_h = H / h[:, None, None]

        E = self._E_exact(sv6, {"alpha": alpha}, T)

        B = torch.where(h_small[:, None], 0.0, B)
        P = torch.where(h_small[:, None], 0.0, P)
        H_over_h = torch.where(h_small[:, None, None], 0.0, H_over_h)

        new = dict(state)
        new.update(G=E - H_over_h, B=B, r=r, h=h, P=P, h_small=h_small,
                   qsi=qsi)
        return new

    def f_increment_isv(self, state, sv6, sv6_k, dt):
        """delta_alpha = -(r + P:(sigma - sigma_k))/h, alpha kept positive."""
        dsig = sv6 - sv6_k
        pd = (state["P"] * voigt_weight(dsig) * dsig).sum(-1)
        delta = -(state["r"] + pd) / state["h"]
        delta = torch.where(state["h_small"], 0.0, delta)
        new = dict(state)
        new["alpha"] = torch.clamp(state["alpha"] + delta,
                                   min=self.ALPHA_MIN)
        return new

    def f_commit_isv(self, state):
        new = dict(state)
        new["qsi_old"] = state["qsi"]
        return new

    def compute_initial_hardening(self, stress, Fvp_0: float = 0.0):
        """Solve alpha_0 from Fvp = Fvp_0 at the current stress."""
        p = self.params
        s = _cp_mpa(self._sv(stress))
        I1, _, _, J2, J3 = _invariants_cp(s)
        j2_low = J2 <= self.J2_MIN
        J2s = torch.clamp(J2, min=self.J2_MIN)
        Sr = torch.where(j2_low, 0.0, -(J3 * _SQRT27) / (2.0 * J2s ** 1.5))
        I1s = I1 + p["sigma_t"]
        F2i = torch.clamp(torch.exp(p["beta_1"] * I1s) - p["beta"] * Sr,
                          min=self.F2_MIN)
        a0 = (p["gamma"] * I1s ** (2 - p["n"])
              + (Fvp_0 - J2s) * I1s ** (-p["n"]) * F2i ** (-p["m"]))
        ALPHA_MIN0 = 1e-6
        self.ind_desai_disabled = torch.where(a0 <= ALPHA_MIN0)[0]
        alpha_0 = torch.clamp(a0, min=ALPHA_MIN0)
        self.params = dict(self.params, alpha_0=alpha_0)
        new = dict(self.state)
        new["alpha"] = alpha_0
        new["Fvp"] = self._Fvp(alpha_0, I1s, J2s, Sr, self.params)
        self.state = new

    # -- reference-style views --------------------------------------------- #
    @property
    def alpha(self):
        return self.state["alpha"]

    @property
    def alpha_0(self):
        return self.params["alpha_0"]

    @property
    def Fvp(self):
        return self.state["Fvp"]

    @property
    def qsi(self):
        return self.state["qsi"]

    @property
    def qsi_old(self):
        return self.state["qsi_old"]

    @property
    def r(self):
        return self.state["r"]

    @property
    def h(self):
        return self.state["h"]

    @property
    def P(self):
        return voigt_to_tensor(self.state["P"])


def _dp_flow(s, alpha_Q):
    """Drucker-Prager non-associated flow direction (E, 6), with I1 and the
    floored J2, from compression-positive components."""
    sxx, syy, szz, sxy, sxz, syz = s.unbind(-1)
    I1 = sxx + syy + szz
    I2 = sxx * syy + syy * szz + sxx * szz - sxy ** 2 - syz ** 2 - sxz ** 2
    J2 = torch.clamp(I1 ** 2 / 3.0 - I2, min=1e-20)
    inv2 = 1.0 / (2.0 * torch.sqrt(J2))
    dJ2 = torch.stack([(2. / 3.) * I1 - (syy + szz),
                       (2. / 3.) * I1 - (sxx + szz),
                       (2. / 3.) * I1 - (sxx + syy),
                       2 * sxy, 2 * sxz, 2 * syz], dim=-1)
    return inv2[:, None] * dJ2 - alpha_Q[:, None] * iso6(s), I1, J2


def _perzyna_cutoff_rate(s, F_shear, dQdS, I1, p):
    """(rate (E, 6), Fvp (E,)) of a shear yield function with the tension
    cut-off ``-I1/3 - sigma_t``: the larger of the two drives the flow, the
    cut-off along the hydrostatic axis."""
    F_tension = -I1 / 3.0 - p["sigma_t"]
    Fvp = torch.maximum(F_shear, F_tension)
    is_tension = F_tension > F_shear
    dQdS = torch.where(is_tension[:, None], -iso6(s) / 3.0, dQdS)
    Fvp_safe = torch.where(Fvp > 0, Fvp, 1.0)
    lmbda = torch.where(Fvp > 0, p["mu_1"] * Fvp_safe ** p["N_1"], 0.0)
    return -dQdS * lmbda[:, None], Fvp


def _host(x) -> np.ndarray:
    """A parameter as host float64 (a tensor on any device included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


class _PerfectViscoplastic(NonElasticElement):
    """A viscoplastic element without internal variables whose
    ``_rate_static(sv6, p)`` returns (rate, Fvp)."""

    F_0 = 1.0   # the overstress is normalised by 1 MPa

    def __init__(self, n_elems, name, device, cohesion, friction_angle,
                 dilation_angle):
        super().__init__(n_elems, name, device)
        self.cohesion = _host(cohesion)
        self.friction_angle = _host(friction_angle)
        self.dilation_angle = _host(dilation_angle)
        self.state["Fvp"] = self._zeros(n_elems)

    def _rate(self, sv6, isv, T, p):
        return self._rate_static(sv6, p)[0]

    def f_rate(self, state, sv6, phi1, T):
        new = dict(state)
        new["rate"], new["Fvp"] = self._rate_static(sv6, self._p(sv6.dtype))
        return new

    @property
    def Fvp(self):
        return self.state["Fvp"]


class MohrCoulombViscoplastic(_PerfectViscoplastic):
    """Drucker-Prager circumscription of Mohr-Coulomb with a tension
    cut-off; non-associated flow through the dilation angle."""

    def __init__(self, mu_1, N_1, cohesion, friction_angle, dilation_angle,
                 sigma_t, name: str = "mohr_coulomb", device=None):
        args = (mu_1, N_1, cohesion, friction_angle, dilation_angle, sigma_t)
        if any(isinstance(x, torch.Tensor) and x.requires_grad
               for x in args):
            # a calibration differentiates through the constructor: the
            # Drucker-Prager coefficients stay tensors with their history
            NonElasticElement.__init__(self, len(mu_1), name, device)
            xp, t = torch, self._tensor
            self.cohesion, self.friction_angle, self.dilation_angle = \
                t(cohesion), t(friction_angle), t(dilation_angle)
            self.state["Fvp"] = self._zeros(self.n_elems)
        else:
            super().__init__(len(mu_1), name, device, cohesion,
                             friction_angle, dilation_angle)
            xp, t = np, self._tensor
        sin_phi, cos_phi = xp.sin(self.friction_angle), \
            xp.cos(self.friction_angle)
        sin_psi = xp.sin(self.dilation_angle)
        sq3 = np.sqrt(3.0)
        self.params = {
            "mu_1": t(mu_1), "N_1": t(N_1), "sigma_t": t(sigma_t),
            "alpha_F": t(2.0 * sin_phi / (sq3 * (3.0 - sin_phi))),
            "k_F": t(6.0 * self.cohesion * cos_phi / (sq3 * (3.0 - sin_phi))),
            "alpha_Q": t(2.0 * sin_psi / (sq3 * (3.0 - sin_psi))),
        }
        self._n_flowing = int(np.count_nonzero(_host(mu_1) > 0))

    @property
    def n_flowing(self):
        """How many elements can flow (mu_1 > 0; the interlayers of a
        nobian mesh): the denominator of :meth:`yield_count`, counted on
        the host when the element is made.  Cells the parallel layer pads
        carry no stress and never yield."""
        return self._n_flowing

    def yield_count(self, state):
        """How many elements that can flow have a positive yield function
        in ``state``: a 0-dim int64 tensor on the element's device, made
        without a host read."""
        return ((state["Fvp"] > 0) & (self.params["mu_1"] > 0)).sum()

    @staticmethod
    def _rate_static(sv6, p):
        s = _cp_mpa(sv6)
        dQdS, I1, J2 = _dp_flow(s, p["alpha_Q"])
        F_shear = torch.sqrt(J2) - p["alpha_F"] * I1 - p["k_F"]
        return _perzyna_cutoff_rate(s, F_shear, dQdS, I1, p)


class MatsuokaNakaiViscoplastic(_PerfectViscoplastic):
    """Matsuoka-Nakai yield (the obliquity form on the principal stresses,
    from the analytic 3x3 eigenvalues) with the Drucker-Prager flow."""

    def __init__(self, mu_1, N_1, cohesion, friction_angle, dilation_angle,
                 sigma_t, name: str = "matsuoka_nakai", device=None):
        super().__init__(len(mu_1), name, device, cohesion, friction_angle,
                         dilation_angle)
        sin_phi, cos_phi = np.sin(self.friction_angle), \
            np.cos(self.friction_angle)
        sin_psi = np.sin(self.dilation_angle)
        safe_sin = np.where(np.abs(sin_phi) < 1e-10, 1.0, sin_phi)
        shift = np.where(np.abs(sin_phi) < 1e-10, 0.0,
                         self.cohesion * cos_phi / safe_sin)
        t = self._tensor
        self.params = {
            "mu_1": t(mu_1), "N_1": t(N_1), "sigma_t": t(sigma_t),
            "k_nfc": t(np.sqrt(2.0) * sin_phi),
            "cohesive_shift": t(shift),
            "alpha_Q": t(2.0 * sin_psi / (np.sqrt(3.0) * (3.0 - sin_psi))),
        }

    @staticmethod
    def _rate_static(sv6, p):
        s = _cp_mpa(sv6)
        eig = eigvalsh3x3(voigt_to_tensor(s))               # ascending
        sig3_s = eig[:, 0] + p["cohesive_shift"]
        sig2_s = eig[:, 1] + p["cohesive_shift"]
        sig1_s = eig[:, 2] + p["cohesive_shift"]

        d12 = torch.clamp(sig1_s + sig2_s, min=1e-20)
        d23 = torch.clamp(sig2_s + sig3_s, min=1e-20)
        d31 = torch.clamp(sig3_s + sig1_s, min=1e-20)
        sin2 = (((sig1_s - sig2_s) / d12) ** 2
                + ((sig2_s - sig3_s) / d23) ** 2
                + ((sig3_s - sig1_s) / d31) ** 2)
        f_nfc = torch.sqrt(sin2 + 1e-30) - p["k_nfc"]
        p_mean = torch.clamp((sig1_s + sig2_s + sig3_s) / 3.0, min=1e-20)

        dQdS, I1, _ = _dp_flow(s, p["alpha_Q"])
        return _perzyna_cutoff_rate(s, f_nfc * p_mean, dQdS, I1, p)
