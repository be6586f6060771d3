"""The plain reference's finite-element model: P1 tetrahedra, a dense
global stiffness, a direct solve, and SafeInCave's theta-scheme fixed
point, in plain PyTorch.

It shares no code with the program under test.  The discrete problem is the
one the program states: each time step iterates consistent tangent ->
right-hand side -> linear solve -> strain, stress, internal variables and
rates until the relative strain change (shear weighted twice) falls to the
tolerance, and the converged step commits the inelastic strains.  Where the
program solves with Krylov iterations in float32 under float64 defect
correction, the reference assembles the whole matrix and factorizes it, in
the dtype it runs in (float64 for the reference, float32 for the control).
"""
from __future__ import annotations

import numpy as np
import torch

from .materials import ISO, KINDS, W, apply66, isotropic


def per_element(mesh, value, rules):
    """A number, or a {group: number} map over the mesh's regions (each
    region's group is the first ``rules`` entry [substring, group] found in
    its name, else "default"), as an (E,) float64 array."""
    if not isinstance(value, dict):
        return np.full(mesh.n_elems, float(value))
    out = np.zeros(mesh.n_elems)
    for name in mesh.region_names():
        group = next((g for sub, g in rules if sub in name), "default")
        out[mesh.region_of(name)] = float(value[group])
    return out


class Model:
    """One configuration's equation on ``mesh``: materials from ``cfg``
    ("materials", "regions", "temperature_K", "theta", "supports"), in
    ``dtype`` on ``device``.

    ``T`` (E,) is the element temperature the creep laws read, ``T0`` (E,)
    the temperature of zero thermal strain.  A "thermoelastic" material
    (expansion coefficient ``alpha``) adds the thermal strain
    alpha (T - T0) I to the inelastic strain of the right-hand side, as the
    program's ``eps_th`` does; without one there is no thermal strain."""

    def __init__(self, mesh, cfg, dtype=torch.float64, device="cpu"):
        self.mesh, self.dtype, self.device = mesh, dtype, torch.device(device)
        self.theta = float(cfg["theta"])
        rules = cfg.get("regions", [])
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa
                                      device=self.device)
        n = mesh.n_elems
        self.T = t(np.full(n, float(cfg["temperature_K"])))
        self.T0 = self.T.clone()
        self.alpha = None
        self.mechs = []
        for spec in cfg["materials"]:
            kind = spec["type"]
            vals = {k: per_element(mesh, v, rules)
                    for k, v in spec.items() if k not in ("type", "name")}
            if kind == "spring":
                self.C, self.C_inv = isotropic(t(vals["E"]), t(vals["nu"]))
            elif kind == "thermoelastic":
                self.alpha = t(vals["alpha"])
            else:
                self.mechs.append(KINDS[kind](n, dtype, self.device, **vals))
        self.grad = t(mesh.grad)                               # (E, 4, 3)
        self.vol = t(mesh.vol)
        self.tets = torch.as_tensor(mesh.tets, device=self.device)
        self.dofs = (3 * self.tets[:, :, None]
                     + torch.arange(3, device=self.device)).reshape(n, 12)
        self.Bm = self._strain_matrix()
        names = mesh.boundary_names()
        fixed = [(f, c) for f, c in cfg["supports"] if f in names] \
            or [(names[0], c) for c in range(3)]
        free = np.ones((mesh.n_nodes, 3))
        for face, comp in fixed:
            free[np.unique(mesh.tris[mesh.facets(face)]), comp] = 0.0
        self.fixed = torch.as_tensor(np.nonzero(free.reshape(-1) == 0)[0],
                                     device=self.device)
        self.u = torch.zeros(mesh.n_nodes, 3, dtype=dtype, device=self.device)
        self.sv = torch.zeros(n, 6, dtype=dtype, device=self.device)
        self.eps = torch.zeros_like(self.sv)
        self.w = torch.tensor(W, dtype=dtype, device=self.device)

    # -- the P1 operators ------------------------------------------------ #
    def _strain_matrix(self):
        """B (E, 6, 12): tensorial Voigt strain of the 12 element dofs."""
        g = self.grad
        B = torch.zeros(g.shape[0], 6, 12, dtype=self.dtype,
                        device=self.device)
        for a in range(4):
            gx, gy, gz = g[:, a, 0], g[:, a, 1], g[:, a, 2]
            x, y, z = 3 * a, 3 * a + 1, 3 * a + 2
            B[:, 0, x], B[:, 1, y], B[:, 2, z] = gx, gy, gz
            B[:, 3, x], B[:, 3, y] = 0.5 * gy, 0.5 * gx
            B[:, 4, x], B[:, 4, z] = 0.5 * gz, 0.5 * gx
            B[:, 5, y], B[:, 5, z] = 0.5 * gz, 0.5 * gy
        return B

    def strain(self, u):
        return torch.einsum("ekd,ed->ek", self.Bm, u.reshape(-1)[self.dofs])

    def force(self, sv):
        """Nodal forces (N, 3) of element stresses: V B^T W sigma."""
        fe = torch.einsum("ekd,ek->ed", self.Bm, sv * self.w) * self.vol[:,
                                                                          None]
        f = torch.zeros(3 * self.mesh.n_nodes, dtype=self.dtype,
                        device=self.device)
        f.index_add_(0, self.dofs.reshape(-1), fe.reshape(-1))
        return f.reshape(-1, 3)

    def stiffness(self, CT):
        """The dense global matrix of V B^T W CT B, constrained rows and
        columns replaced by the identity."""
        nd = 3 * self.mesh.n_nodes
        Ke = torch.einsum("eki,ekl,elj->eij", self.Bm,
                          CT * self.w[None, :, None], self.Bm) \
            * self.vol[:, None, None]
        K = torch.zeros(nd, nd, dtype=self.dtype, device=self.device)
        rows = self.dofs[:, :, None].expand(-1, 12, 12).reshape(-1)
        cols = self.dofs[:, None, :].expand(-1, 12, 12).reshape(-1)
        K.index_put_((rows, cols), Ke.reshape(-1), accumulate=True)
        K[self.fixed, :] = 0.0
        K[:, self.fixed] = 0.0
        K[self.fixed, self.fixed] = 1.0
        return K

    def solve(self, CT, b, rtol=None):
        """u of K(CT) u = b with the supports held at zero, to a relative
        residual of ``rtol`` (1e-12 in float64, 1e-6 in float32).  The LU
        factors of the last matrix factorized precondition a refinement
        (x += LU^-1 (b - K x)); when that does not reach ``rtol`` within
        eight sweeps, K itself is factorized and solved directly."""
        rtol = rtol or (1e-12 if self.dtype == torch.float64 else 1e-6)
        K = self.stiffness(CT)
        rhs = b.reshape(-1).clone()
        rhs[self.fixed] = 0.0
        bnorm = torch.linalg.norm(rhs)
        if getattr(self, "_lu", None) is not None:
            x = torch.zeros_like(rhs)
            for _ in range(8):
                r = rhs - K @ x
                if torch.linalg.norm(r) <= rtol * bnorm:
                    return x.reshape(-1, 3)
                x = x + torch.linalg.lu_solve(*self._lu, r[:, None])[:, 0]
        LU, piv, info = torch.linalg.lu_factor_ex(K)
        self._lu = (LU, piv)
        x = torch.linalg.lu_solve(LU, piv, rhs[:, None])[:, 0]
        if int(info) != 0:
            x = torch.full_like(x, float("nan"))
        return x.reshape(-1, 3)

    # -- time stepping ---------------------------------------------------- #
    def consistent_tangent(self, G, phi2):
        CT, info = torch.linalg.inv_ex(self.C_inv + phi2 * G)
        return torch.where((info == 0)[:, None, None], CT,
                           torch.linalg.inv(self.C_inv))

    def elastic(self, b):
        """The elastic response to the loads ``b`` (N, 3)."""
        self.u = self.solve(self.C, b)
        self.eps = self.strain(self.u)
        self.sv = apply66(self.C, self.eps)

    def initial_rates(self):
        """Every mechanism's rate at the current stress (no history term),
        rolled into its committed rate."""
        for m in self.mechs:
            m.update_rate(self.sv, 0.0, self.T)
            m.s["rate_old"] = m.s["rate"]

    def thermal_strain(self):
        """alpha (T - T0) I (E, 6), or None without a thermoelastic
        material."""
        if self.alpha is None:
            return None
        iso = torch.tensor(ISO, dtype=self.dtype, device=self.device)
        return (self.alpha * (self.T - self.T0))[:, None] * iso

    def step(self, b, dt, tol, maxiter, strict=True):
        """One time step of length ``dt`` under the loads ``b`` (N, 3) at
        its end: the fixed point, then the commit.  Returns (iterations,
        error).  ``strict`` raises when the error did not reach ``tol``;
        otherwise (a control in a lower precision, whose error stalls above
        the tolerance) the iteration stops three iterations after its least
        error, or at a non-finite one, and that least-error iterate is
        committed."""
        phi1, phi2 = dt * self.theta, dt * (1 - self.theta)
        sv, eps = self.sv, self.eps
        eps_th = self.thermal_strain()
        ite, err, best = 0, 1.0, None
        while True:
            sv_k = sv
            G = B = eps_ne = 0.0
            for m in self.mechs:
                m.tangent(sv_k, self.T, dt, self.theta)
                m.predictor(phi1, phi2)
                G, B = G + m.s["G"], B + m.s["B"]
                eps_ne = eps_ne + m.s["eps_k"]
            if eps_th is not None:
                eps_ne = eps_ne + eps_th
            CT = self.consistent_tangent(G, phi2)
            eps_rhs = eps_ne - phi2 * (B + apply66(G, sv_k))
            u = self.solve(CT, b + self.force(apply66(CT, eps_rhs)))
            eps_new = self.strain(u)
            sv = apply66(CT, eps_new - eps_rhs)
            for m in self.mechs:
                m.increment(sv, sv_k, dt)
                m.update_rate(sv, phi1, self.T)
            err = float(torch.sqrt((((eps_new - eps) ** 2) * self.w).sum())
                        / torch.sqrt(((eps_new ** 2) * self.w).sum()))
            eps, ite = eps_new, ite + 1
            stalled = False
            if not strict:
                if best is None or err < best[0]:
                    best = (err, u, sv, eps, sv_k,
                            [dict(m.s) for m in self.mechs], ite)
                stalled = not err < float("inf") or ite - best[6] >= 3
            if err <= tol or ite >= maxiter or stalled:
                break
        if strict and not err <= tol:
            raise RuntimeError(f"reference step did not converge: err "
                               f"{err:.3e} after {ite} iterations")
        if not strict:
            err, u, sv, eps, sv_k, states, _ = best
            for m, st in zip(self.mechs, states):
                m.s = st
        for m in self.mechs:
            m.commit(sv, sv_k, phi2)
        self.u, self.sv, self.eps = u, sv, eps
        return ite, err

    # -- outputs ---------------------------------------------------------- #
    def field(self, name):
        """An output field as SaveFields writes it: "u" (N, 3), "p_elems" and
        "q_elems" (E,) smoothed from the element stresses."""
        if name == "u":
            return self.u
        s = self.sv
        I1 = s[:, :3].sum(1)
        if name == "p_elems":
            return self.mesh.smooth(I1 / 3.0)
        if name == "q_elems":
            I2 = (s[:, 0] * s[:, 1] + s[:, 1] * s[:, 2] + s[:, 0] * s[:, 2]
                  - (s[:, 3:] ** 2).sum(1))
            return self.mesh.smooth(torch.sqrt(torch.clamp(
                3.0 * (I1 ** 2 / 3.0 - I2), min=0.0)))
        raise KeyError(name)

    def state(self):
        """The state a checkpoint holds, under the checkpoint's keys:
        u, sig_v, eps_tot_v and, per mechanism k in the configuration's
        order, elem{k}_eps_old and its internal variables."""
        out = {"u": self.u, "sig_v": self.sv, "eps_tot_v": self.eps}
        for k, m in enumerate(self.mechs):
            out[f"elem{k}_eps_old"] = m.s["eps_old"]
            for key in ("alpha", "qsi_old"):
                if key in m.s:
                    out[f"elem{k}_{key}"] = m.s[key]
        return {k: v.detach().double().cpu().numpy() for k, v in out.items()}


def neumann(mesh, faces, pressure, density=0.0, ref_z=0.0, g=0.0):
    """Nodal loads (N, 3) of a pressure ``pressure`` (Pa, compressive) on
    the boundary ``faces``, with the fluid column density * g * (ref_z - z)
    added (g negative downwards): the traction -p + rho g (ref_z - z) along
    the outward normal, integrated exactly for a linear integrand."""
    f = np.zeros((mesh.n_nodes, 3))
    for face in faces:
        idx = mesh.facets(face)
        tris = mesh.tris[idx]
        v = -pressure + density * g * (ref_z - mesh.points[tris][:, :, 2])
        w = mesh.tri_area[idx, None] / 12.0 * (v.sum(1, keepdims=True) + v)
        np.add.at(f, tris.reshape(-1), (w[:, :, None]
                                        * mesh.tri_normal[idx, None, :])
                  .reshape(-1, 3))
    return f
