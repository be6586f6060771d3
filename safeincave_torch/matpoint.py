"""Material-point (0-D) simulator and differentiable calibration.

Port of ``safeincave_tpu/matpoint.py``.  The point integrators run the same
theta-scheme mechanisms as the finite-element solver, on the device of the
material they are given.  The JAX package scans and jits its loops; here
they are Python loops over tensors, and the whole stress- or strain-driven
integration stays differentiable through ``torch.autograd``, so
:func:`calibrate` fits parameters with exact gradients.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import default_device
from .materials.base import _as_voigt, apply66
from .utils import voigt_to_tensor

F64 = torch.float64

# the Newton step of the triaxial twin falls back to the elastic compliance
# where the residual's slope vanishes
_DR_MIN = 1e-30


def apply66_rows(M, v):
    """(n, 6) result of the batched (n, 6, 6) @ (n, 6)."""
    return apply66(M, v)


def _sum_eps_old(states, n, device):
    """Total committed inelastic strain (n, 6) over the mechanisms."""
    if not states:
        return torch.zeros((n, 6), dtype=F64, device=device)
    return sum(st["eps_old"] for st in states)


class MaterialPointSimulator:
    """Integrate the inelastic response at material points under a
    prescribed stress history (the triaxial-test setting of a calibration).

    Per step: tangent -> ISV increment (with sigma = sigma_k) -> rate ->
    predictor -> commit, on ``mat``'s device.
    """

    def __init__(self, mat, theta: float = 0.5, Temp=None):
        self.mat = mat
        self.theta = theta
        self.device = mat.device
        n = mat.n_elems
        self.Temp = (torch.full((n,), 298.0, dtype=F64, device=self.device)
                     if Temp is None
                     else torch.as_tensor(Temp, dtype=F64).to(self.device))

    def run(self, stress_history, times):
        """Integrate under the prescribed stress path.

        ``stress_history``: (T, 3, 3), (T, n_pts, 3, 3) or (T, n_pts, 6),
        the stress at each time (SafeInCave signs, Pa); ``times`` (T,)
        seconds.  Returns a dict with "eps_ne" (T, n_pts, 3, 3), "eps_e",
        "eps_total", and each mechanism's internal-variable histories.
        """
        mat, theta, n = self.mat, self.theta, self.mat.n_elems
        times = np.asarray(times, dtype=float)
        hist = np.asarray(stress_history, dtype=float)
        if hist.ndim == 3 and hist.shape[1:] == (3, 3):
            hist = np.broadcast_to(hist[:, None], (hist.shape[0], n, 3, 3))
        sv_hist = [_as_voigt(np.ascontiguousarray(h)).to(self.device)
                   for h in hist]
        elems = mat.elems_ne
        states = [dict(e.state) for e in elems]
        out_eps_ne = []
        out_isv = {e.name: [] for e in elems}

        sv = sv_hist[0]
        # initial rates at the first stress state
        states = [e.f_rate(st, sv, 0.0, self.Temp)
                  for e, st in zip(elems, states)]
        states = [e.f_rate_to_old(st) for e, st in zip(elems, states)]
        out_eps_ne.append(_sum_eps_old(states, n, self.device))
        self._record_isv(states, out_isv)

        for k in range(1, len(times)):
            dt = float(times[k] - times[k - 1])
            sv_k, sv = sv_hist[k - 1], sv_hist[k]
            new_states = []
            for e, st in zip(elems, states):
                st = e.f_tangent(st, sv_k, self.Temp, dt, theta)
                st = e.f_increment_isv(st, sv, sv_k, dt)
                st = e.f_rate(st, sv, dt * theta, self.Temp)
                st = e.f_eps_k(st, dt * theta, dt * (1 - theta))
                st = e.f_commit_isv(st)
                st = e.f_update_eps_old(st, sv, sv_k, dt * (1 - theta))
                st = e.f_rate_to_old(st)
                new_states.append(st)
            states = new_states
            out_eps_ne.append(_sum_eps_old(states, n, self.device))
            self._record_isv(states, out_isv)

        for e, st in zip(elems, states):
            e.state = st

        eps_ne = torch.stack(out_eps_ne)                     # (T, n, 6)
        eps_e = torch.stack([apply66(mat.C_inv, s) for s in sv_hist])
        result = {
            "times": times,
            "eps_ne": voigt_to_tensor(eps_ne),
            "eps_e": voigt_to_tensor(eps_e),
            "eps_total": voigt_to_tensor(eps_ne + eps_e),
        }
        for name, vals in out_isv.items():
            if vals and vals[0]:
                result[name] = {
                    key: np.stack([v[key].detach().cpu().numpy()
                                   for v in vals]) for key in vals[0]}
        return result

    @staticmethod
    def _record_isv(states, out_isv):
        for name, st in zip(out_isv, states):
            out_isv[name].append({key: st[key] for key in
                                  ("alpha", "qsi", "Fvp", "zeta", "F")
                                  if key in st})


class TriaxialSimulator(MaterialPointSimulator):
    """Mixed-control triaxial compression twin: prescribed axial strain (a
    strain-rate-controlled ram) at fixed radial confinement.

    Per step the axial stress is the root of the scalar consistency
    equation  C_inv[2, :] . sigma + eps_ne_zz(sigma) = eps_zz_prescribed  at
    fixed sig_xx = sig_yy = Sr, found by ``n_fp`` Newton steps through the
    material's predictor.
    """

    def run_compression(self, Sr, eps_axial, times, n_fp: int = 12):
        """Integrate a strain-driven compression path.

        ``Sr``: scalar or (n_pts,) radial confinement (Pa, compression
        negative).  ``eps_axial``: (T,) or (T, n_pts) prescribed total axial
        strain, ``eps_axial[0]`` consistent with the initial isotropic state
        sigma = Sr I.  ``times``: (T,) seconds.

        Returns a dict with the "sig_zz", "eps_vol" and "eps_ne" histories
        ((T, n_pts) / (T, n_pts, 6)) and "S_diff" = sig_xx - sig_zz
        (positive in compression).
        """
        mat, theta, n, dev = self.mat, self.theta, self.mat.n_elems, \
            self.device
        times = np.asarray(times, dtype=float)
        Sr = torch.as_tensor(Sr, dtype=F64).to(dev).broadcast_to((n,))
        ez = torch.as_tensor(eps_axial, dtype=F64).to(dev)
        if ez.dim() == 1:
            ez = ez[:, None].broadcast_to((len(times), n))
        Temp = self.Temp
        Ci = mat.C_inv                                        # (n, 6, 6)
        Ci_zz = Ci[:, 2, 2]
        Ci_zr = Ci[:, 2, 0] + Ci[:, 2, 1]
        elems = mat.elems_ne

        def sv_of(szz):
            z = torch.zeros_like(szz)
            return torch.stack([Sr, Sr, szz, z, z, z], dim=-1)

        def trial_eps_ne(tangents, sv, sv_k, dt):
            """End-of-step inelastic strain for a trial end stress, from
            the step's tangent states (built at ``sv_k``, so the same for
            every trial)."""
            tot = torch.zeros((n, 6), dtype=F64, device=dev)
            new_states = []
            for e, st in zip(elems, tangents):
                st = e.f_increment_isv(st, sv, sv_k, dt)
                st = e.f_rate(st, sv, dt * theta, Temp)
                st = e.f_eps_k(st, dt * theta, dt * (1 - theta))
                upd = e.f_update_eps_old(st, sv, sv_k, dt * (1 - theta))
                tot = tot + upd["eps_old"]
                new_states.append(st)
            return tot, new_states

        states = [dict(e.state) for e in elems]
        # initial rates at the isotropic state
        sv0 = sv_of(Sr)
        states = [e.f_rate(st, sv0, 0.0, Temp)
                  for e, st in zip(elems, states)]
        states = [e.f_rate_to_old(st) for e, st in zip(elems, states)]
        eps_ne0 = _sum_eps_old(states, n, dev)
        ev0 = apply66(Ci, sv0)[:, :3].sum(-1) + eps_ne0[:, :3].sum(-1)

        szz_hist, evol_hist, eps_ne_hist = [Sr], [ev0], [eps_ne0]
        szz_k = Sr
        for k in range(1, len(times)):
            dt = float(times[k] - times[k - 1])
            ez_t = ez[k]
            sv_k = sv_of(szz_k)
            tangents = [e.f_tangent(st, sv_k, Temp, dt, theta)
                        for e, st in zip(elems, states)]

            def resid(szz):
                eps_ne, _ = trial_eps_ne(tangents, sv_of(szz), sv_k, dt)
                return Ci_zz * szz + Ci_zr * Sr + eps_ne[:, 2] - ez_t

            szz = szz_k
            for _ in range(n_fp):
                # point-diagonal Jacobian by one JVP (a plain fixed point
                # diverges for stiff Perzyna overstress)
                r, dr = torch.func.jvp(resid, (szz,),
                                       (torch.ones_like(szz),))
                dr = torch.where(dr.abs() > _DR_MIN, dr, Ci_zz)
                szz = szz - r / dr
            sv = sv_of(szz)
            eps_ne, sts = trial_eps_ne(tangents, sv, sv_k, dt)
            # commit with the converged end stress
            states = []
            for e, st in zip(elems, sts):
                st = e.f_commit_isv(st)
                st = e.f_update_eps_old(st, sv, sv_k, dt * (1 - theta))
                st = e.f_rate_to_old(st)
                states.append(st)
            eps_tot = apply66(Ci, sv) + eps_ne
            szz_hist.append(szz)
            evol_hist.append(eps_tot[:, 0] + eps_tot[:, 1] + eps_tot[:, 2])
            eps_ne_hist.append(eps_ne)
            szz_k = szz

        for e, st in zip(elems, states):
            e.state = st
        szz = torch.stack(szz_hist)
        return {
            "times": times,
            "sig_zz": szz,
            "S_diff": Sr[None, :] - szz,
            "eps_axial": ez,
            "eps_vol": torch.stack(evol_hist),
            "eps_ne": torch.stack(eps_ne_hist),
        }


def calibrate(build_result_fn, params0: dict, observed, lr: float = 0.05,
              steps: int = 200, loss_scale=None, device=None):
    """Gradient-based parameter calibration.

    ``build_result_fn(params) -> prediction tensor`` is a differentiable
    function of a dict of float64 tensors on ``device`` (default: the
    card); the loss is the mean squared error against ``observed``, divided
    by ``loss_scale``.  Adam in log space (which keeps the parameters
    positive) with a cosine decay of the rate from ``lr`` to ``0.05 lr``;
    the returned parameters are those of the best loss seen, not the last
    ones.  Returns (fitted parameters as numpy arrays, loss history with the
    best loss appended).
    """
    device = torch.device(device) if device else default_device()

    def as_t(x):
        return torch.as_tensor(np.array(x, dtype=np.float64),
                               device=device)

    observed = as_t(observed)
    scale = as_t(1.0 if loss_scale is None else loss_scale)
    log_params = {k: torch.log(as_t(v)) for k, v in params0.items()}

    def loss_and_grad(lp):
        leaves = {k: v.detach().requires_grad_(True) for k, v in lp.items()}
        pred = build_result_fn({k: torch.exp(v) for k, v in leaves.items()})
        loss = torch.mean(((pred - observed) / scale) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), dict(zip(leaves, grads))

    history = []
    m = {k: torch.zeros_like(v) for k, v in log_params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in log_params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    best_loss, best = np.inf, dict(log_params)
    for i in range(steps):
        loss, g = loss_and_grad(log_params)
        history.append(loss)
        if loss < best_loss:
            best_loss, best = loss, dict(log_params)
        lr_i = lr * (0.05 + 0.95 * 0.5
                     * (1 + np.cos(np.pi * i / max(steps - 1, 1))))
        for k in log_params:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1 - b2) * g[k] ** 2
            mhat = m[k] / (1 - b1 ** (i + 1))
            vhat = v2[k] / (1 - b2 ** (i + 1))
            log_params[k] = log_params[k] - lr_i * mhat / (torch.sqrt(vhat)
                                                           + eps)
    loss, _ = loss_and_grad(log_params)
    if loss < best_loss:
        best_loss, best = loss, dict(log_params)
    history.append(best_loss)
    fitted = {k: torch.exp(v).cpu().numpy() for k, v in best.items()}
    return fitted, history
