"""Shared machinery for inelastic constitutive elements.

Port of ``safeincave_tpu/materials/base.py``.  Every element keeps its
per-element state in a dict of tensors (``self.state``) with Voigt
``(N, 6)`` strain storage:

==============  =========  ==============================================
key             shape      meaning
==============  =========  ==============================================
``rate``        (N, 6)     inelastic strain rate
``rate_old``    (N, 6)     rate at the last committed step
``eps_old``     (N, 6)     committed inelastic strain
``eps_k``       (N, 6)     theta-scheme predictor
``G``           (N, 6, 6)  tangent-like operator G = E - H/h
``B``           (N, 6)     internal-variable driving term
==============  =========  ==============================================

plus model-specific internal variables.  The ``f_*`` methods map
``state -> state`` without mutation; the reference-style methods delegate
to them.

The flow Jacobian ``E = d(rate)/d(sigma_voigt)`` is exact: one forward-mode
JVP of the batched rate with the six unit tangents stacked along the element
axis gives all six columns at once, and the shear columns are doubled
(``VOIGT_WEIGHT``) as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import default_device
from ..utils import tensor_to_voigt, voigt_to_tensor, voigt_weight

F64 = torch.float64


def apply66(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched Voigt 6x6 apply ``M @ v`` for M (E, 6, 6), v (E, 6)."""
    return (M * v[:, None, :]).sum(-1)


def _as_voigt(stress) -> torch.Tensor:
    """Accept (N, 3, 3) tensors (reference API) or (N, 6) Voigt arrays."""
    stress = torch.as_tensor(stress, dtype=F64)
    if stress.dim() >= 2 and stress.shape[-2:] == (3, 3):
        return tensor_to_voigt(stress)
    return stress


class NonElasticElement:
    """Base for inelastic mechanisms (creep / viscoelastic / viscoplastic)."""

    def __init__(self, n_elems: int, name: str, device=None):
        self.n_elems = n_elems
        self.name = name
        self.device = torch.device(device) if device else default_device()
        self.params: dict = {}
        z6 = self._zeros(n_elems, 6)
        self.state: dict = {
            "rate": z6, "rate_old": z6, "eps_old": z6, "eps_k": z6,
            "G": self._zeros(n_elems, 6, 6), "B": z6,
        }

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=F64, device=self.device)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=self.device)

    # -- model hooks ------------------------------------------------------ #
    def _rate(self, sv6, isv, T, p):
        """Batched strain rate: (E, 6) Voigt stress -> (E, 6) Voigt rate.

        ``isv`` is a dict of (E,) internal variables, ``p`` the dict of (E,)
        parameters."""
        raise NotImplementedError

    def _isv_slice(self, state):
        """Internal variables (dict of (E,) tensors) consumed by `_rate`."""
        return {}

    # -- batched rate + exact tangent ------------------------------------- #
    def _p(self, dtype):
        """Parameters in the compute dtype.

        The stored parameters are float64; multiplying them into a float32
        computation would promote it back to float64, so the f32 fixed-point
        sweep computes with a float32 shadow, made again whenever ``params``
        is replaced."""
        if dtype != torch.float32:
            return self.params
        if getattr(self, "_params32_of", None) is not self.params:
            self._params32 = {k: v.to(dtype) for k, v in self.params.items()}
            self._params32_of = self.params
        return self._params32

    def _E_exact(self, sv6, isv, T):
        """Exact E = d(rate)/d(sigma_voigt) (E, 6, 6), shear columns doubled.

        The six unit tangents are stacked along the element axis, so one JVP
        of the element-wise rate yields every column."""
        E = sv6.shape[0]
        rep = lambda x: x.repeat(6)  # noqa: E731
        p6 = {k: rep(v) for k, v in self._p(sv6.dtype).items()}
        isv6 = {k: rep(v) for k, v in isv.items()}
        T6 = rep(T)
        tangent = torch.eye(6, dtype=sv6.dtype, device=sv6.device)
        tangent = tangent[:, None, :].expand(6, E, 6).reshape(6 * E, 6)
        _, jv = torch.func.jvp(lambda s: self._rate(s, isv6, T6, p6),
                               (sv6.repeat(6, 1),), (tangent,))
        jac = jv.reshape(6, E, 6).permute(1, 2, 0)   # [e, i, k] = d r_i/d s_k
        return jac * voigt_weight(jac)

    # -- pure-functional API ---------------------------------------------- #
    def f_rate_value(self, state, sv6, phi1, T):
        """Rate without state mutation."""
        return self._rate(sv6, self._isv_slice(state), T,
                          self._p(sv6.dtype))

    def f_rate(self, state, sv6, phi1, T):
        new = dict(state)
        new["rate"] = self.f_rate_value(state, sv6, phi1, T)
        return new

    def f_tangent(self, state, sv6, T, dt, theta):
        """G (and B): default B = 0, no internal-variable coupling, G = E."""
        new = dict(state)
        new["G"] = self._E_exact(sv6, self._isv_slice(state), T)
        new["B"] = torch.zeros_like(state["B"])
        return new

    def f_eps_k(self, state, phi1, phi2):
        """theta-scheme predictor."""
        new = dict(state)
        new["eps_k"] = (state["eps_old"] + phi1 * state["rate_old"]
                        + phi2 * state["rate"])
        return new

    def f_update_eps_old(self, state, sv6, sv6_k, phi2):
        """eps_old <- eps_k + phi2 G:(sigma - sigma_k) - phi2 B."""
        new = dict(state)
        dG = apply66(state["G"], sv6 - sv6_k)
        new["eps_old"] = state["eps_k"] + phi2 * dG - phi2 * state["B"]
        return new

    def f_rate_to_old(self, state):
        new = dict(state)
        new["rate_old"] = state["rate"]
        return new

    def f_increment_isv(self, state, sv6, sv6_k, dt):
        """Linearized internal-variable increment (default: none)."""
        return state

    def f_commit_isv(self, state):
        """Commit internal variables of a converged step (default: none)."""
        return state

    # -- reference-compatible mutating API -------------------------------- #
    def compute_G_B(self, stress, dt, theta, Temp):
        self.state = self.f_tangent(self.state, self._sv(stress),
                                    self._T(Temp), dt, theta)

    def compute_eps_ne_rate(self, stress, phi1, Temp, return_eps_ne=False):
        sv6 = self._sv(stress)
        if return_eps_ne:
            return voigt_to_tensor(self.f_rate_value(self.state, sv6, phi1,
                                                     self._T(Temp)))
        self.state = self.f_rate(self.state, sv6, phi1, self._T(Temp))

    def compute_eps_ne_k(self, phi1, phi2):
        self.state = self.f_eps_k(self.state, phi1, phi2)

    def update_eps_ne_old(self, stress, stress_k, phi2):
        self.state = self.f_update_eps_old(self.state, self._sv(stress),
                                           self._sv(stress_k), phi2)

    def update_eps_ne_rate_old(self):
        self.state = self.f_rate_to_old(self.state)

    def increment_internal_variables(self, stress, stress_k, dt):
        self.state = self.f_increment_isv(self.state, self._sv(stress),
                                          self._sv(stress_k), dt)

    def update_internal_variables(self):
        self.state = self.f_commit_isv(self.state)

    def _sv(self, stress):
        return _as_voigt(stress).to(self.device)

    def _T(self, Temp):
        return torch.as_tensor(Temp, dtype=F64).to(self.device)

    # -- reference-style views -------------------------------------------- #
    @property
    def eps_ne_rate(self):
        return voigt_to_tensor(self.state["rate"])

    @property
    def eps_ne_rate_old(self):
        return voigt_to_tensor(self.state["rate_old"])

    @property
    def eps_ne_old(self):
        return voigt_to_tensor(self.state["eps_old"])

    @property
    def eps_ne_k(self):
        return voigt_to_tensor(self.state["eps_k"])

    @property
    def G(self):
        return self.state["G"]

    @property
    def B(self):
        return voigt_to_tensor(self.state["B"])
