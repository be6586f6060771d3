"""Heat-equation boundary conditions (port of safeincave_tpu/bcs/heat_bc.py):
Dirichlet, Neumann flux and Robin.

A Robin condition contributes a bilinear facet-mass term ``h (dT, v)_Gamma``
(part of the operator) and a linear term ``h T_inf (v)_Gamma`` (right-hand
side), both exact on boundary triangles:

    facet mass   M_ab = A (1 + delta_ab) / 12
    facet load   b_a  = A / 3 * value      (constant integrand)

The facet tables are built once on the host.  The heat step reads the
conditions through :meth:`BcHandler.tables`, device tables built once per
set of conditions (the Dirichlet mask, a node-to-condition owner table, one
facet-load vector per Neumann or Robin condition, the Robin facets), and
:meth:`BcHandler.values`, the one interpolated scalar per condition that
changes with ``t``: the step's set-up gathers and scales them on the device
(fem/heat.py), so no array is rebuilt or copied per step.  The arrays of a
time ``t`` on their own (mask, values, right-hand sides), the reference's
API, are assembled on the host in float64 and moved to the equation's
device, as the momentum conditions are.  The Robin operator and its
diagonal act on device tensors; their node sums go through a padded gather
(fem/kernels.py ``NodeGather``), so they repeat bit for bit on CUDA.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fem.kernels import NodeGather
from .momentum_bc import interp


class GeneralBC:
    def __init__(self, boundary_name, values, time_values):
        self.boundary_name = boundary_name
        self.values = np.asarray(values, dtype=np.float64)
        self.time_values = np.asarray(time_values, dtype=np.float64)
        self.type = None


class DirichletBC(GeneralBC):
    def __init__(self, boundary_name, values, time_values):
        super().__init__(boundary_name, values, time_values)
        self.type = "dirichlet"


class NeumannBC(GeneralBC):
    def __init__(self, boundary_name, values, time_values):
        super().__init__(boundary_name, values, time_values)
        self.type = "neumann"


class RobinBC(GeneralBC):
    def __init__(self, boundary_name, values, h, time_values):
        super().__init__(boundary_name, values, time_values)
        self.type = "robin"
        self.h = h


class BcHandler:
    """Organizes heat BCs and produces their arrays at a given time."""

    def __init__(self, equation):
        self.eq = equation
        self.grid = equation.grid
        self.device = equation.device
        self.reset_boundary_conditions()

    def reset_boundary_conditions(self):
        self.dirichlet_boundaries = []
        self.neumann_boundaries = []
        self.robin_boundaries = []
        self._dirichlet_meta = []   # (node_indices, times, values)
        self._neumann_meta = []
        self._robin_meta = []
        self._changed()

    def _changed(self):
        """Drop the device tables and the heat step's graphs that read
        them: the set of conditions changed."""
        self._tables = None
        graphs = getattr(self.eq, "graphs", None)
        if graphs is not None:
            graphs.clear()

    def _facet_meta(self, bc):
        facets = np.asarray(self.grid.get_boundary_tags(bc.boundary_name))
        return dict(tris=np.asarray(self.grid.tris[facets], dtype=np.int64),
                    areas=np.asarray(self.grid.tri_areas[facets]),
                    times=bc.time_values, values=bc.values)

    def add_boundary_condition(self, bc: GeneralBC):
        self._changed()
        if bc.type == "dirichlet":
            self.dirichlet_boundaries.append(bc)
            facets = self.grid.get_boundary_tags(bc.boundary_name)
            nodes = np.unique(self.grid.tris[facets].reshape(-1))
            self._dirichlet_meta.append((nodes, bc.time_values, bc.values))
        elif bc.type == "neumann":
            self.neumann_boundaries.append(bc)
            self._neumann_meta.append(self._facet_meta(bc))
        elif bc.type == "robin":
            self.robin_boundaries.append(bc)
            m = self._facet_meta(bc)
            m["h"] = bc.h
            # device side of the bilinear term: the facets' nodes, h A per
            # facet and the node sums' table
            m["tris_t"] = torch.as_tensor(m["tris"], device=self.device)
            m["hA"] = torch.as_tensor(bc.h * m["areas"], device=self.device)
            m["gather"] = NodeGather.build(m["tris"].reshape(-1),
                                           self.grid.n_nodes, self.device)
            self._robin_meta.append(m)
        else:
            raise ValueError(f"Boundary type {bc.type} not supported.")

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------------ #
    def tables(self):
        """The device tables of the conditions, built on first use after a
        change to them: ``mask`` (N,) float64, 1 on free nodes and 0 on
        constrained ones; ``owner`` (N,) int64, the index in
        :meth:`values` of the Dirichlet condition that sets each node (the
        last one added, as in :meth:`dirichlet_arrays`), or of its zero on a
        free node; ``loads`` (C, N) float64, each Neumann and then each
        Robin condition's facet load A / 3 summed onto its nodes; ``robin``
        the Robin facets, as :meth:`robin_operator_apply` takes them."""
        if self._tables is None:
            n = self.grid.n_nodes
            mask = np.ones(n)
            owner = np.full(n, len(self._dirichlet_meta), dtype=np.int64)
            for i, (nodes, _, _) in enumerate(self._dirichlet_meta):
                mask[nodes] = 0.0
                owner[nodes] = i
            facets = self._neumann_meta + self._robin_meta
            loads = np.zeros((len(facets), n))
            for row, m in zip(loads, facets):
                np.add.at(row, m["tris"].reshape(-1),
                          np.repeat(m["areas"] / 3.0, 3))
            self._tables = {"mask": self._tensor(mask),
                            "owner": self._tensor(owner),
                            "loads": self._tensor(loads),
                            "robin": self.robin_tables()}
        return self._tables

    def values(self, t):
        """The conditions' scalars at ``t`` in the order :meth:`tables`
        indexes them: each Dirichlet value, a zero (the free nodes'), each
        Neumann flux, each Robin ``h T_inf``; a host list of floats, by the
        same ``interp`` as the host arrays."""
        return ([interp(t, times, values)
                 for _, times, values in self._dirichlet_meta] + [0.0]
                + [interp(t, m["times"], m["values"])
                   for m in self._neumann_meta]
                + [m["h"] * interp(t, m["times"], m["values"])
                   for m in self._robin_meta])

    def step_arrays(self, vals, tables):
        """(mask, T_bc, facet load) of one step from the device scalars
        ``vals`` (:meth:`values`) and ``tables``: ``T_bc`` a gather of the
        Dirichlet values through the owner table, the load the Neumann and
        Robin right-hand sides together, each condition's fixed load vector
        scaled by its scalar.  Device ops only, for a captured graph."""
        T_bc = vals[tables["owner"]]
        loads = tables["loads"]
        scales = vals[len(vals) - loads.shape[0]:]
        return tables["mask"], T_bc, (scales[:, None] * loads).sum(0)

    # ------------------------------------------------------------------ #
    def dirichlet_arrays(self, t):
        """(mask, T_bc): mask is 1 on free nodes and 0 on constrained ones;
        later BCs overwrite earlier ones on shared nodes."""
        n = self.grid.n_nodes
        mask = np.ones(n)
        T_bc = np.zeros(n)
        for nodes, times, values in self._dirichlet_meta:
            mask[nodes] = 0.0
            T_bc[nodes] = interp(t, times, values)
        return self._tensor(mask), self._tensor(T_bc)

    def _facet_load(self, meta, scale_of):
        """sum over BCs of scale * A / 3 to each facet node, (N,) host."""
        f = np.zeros(self.grid.n_nodes)
        for m in meta:
            w = scale_of(m) * m["areas"][:, None] / 3.0 * np.ones((1, 3))
            seg = np.zeros_like(f)
            np.add.at(seg, m["tris"].reshape(-1), w.reshape(-1))
            f = f + seg
        return self._tensor(f)

    def neumann_rhs(self, t):
        """Flux term: value * (v)_Gamma."""
        return self._facet_load(
            self._neumann_meta,
            lambda m: interp(t, m["times"], m["values"]))

    def robin_rhs(self, t):
        """h * T_inf * (v)_Gamma."""
        return self._facet_load(
            self._robin_meta,
            lambda m: m["h"] * interp(t, m["times"], m["values"]))

    def robin_tables(self):
        """Per Robin condition (facet nodes (F, 3), h A (F,), the node
        sums' padded index table, the contribution count)."""
        return [(m["tris_t"], m["hA"], m["gather"].idx, m["gather"].n_contrib)
                for m in self._robin_meta]

    def robin_operator_apply(self, T: torch.Tensor,
                             robin=None) -> torch.Tensor:
        """Facet-mass action sum_bc h (T, v)_Gamma (bilinear Robin term),
        read from ``robin`` (:meth:`robin_tables`, or copies of them that a
        captured graph binds), by default the handler's own."""
        f = None
        for tris, hA, idx, n in (self.robin_tables() if robin is None
                                 else robin):
            T_e = T[tris]                                          # (F, 3)
            loc = (T_e + T_e.sum(1, keepdim=True)) / 12.0          # (1+d)/12
            s = NodeGather(idx, n).sum(hA.to(T.dtype)[:, None] * loc)
            f = s if f is None else f + s
        if f is None:
            return torch.zeros(self.grid.n_nodes, dtype=T.dtype,
                               device=T.device)
        return f

    def robin_diagonal(self, robin=None) -> torch.Tensor:
        d = torch.zeros(self.grid.n_nodes, dtype=torch.float64,
                        device=self.device)
        for _, hA, idx, n in (self.robin_tables() if robin is None
                              else robin):
            w = (hA * (2.0 / 12.0))[:, None].expand(-1, 3)
            d = d + NodeGather(idx, n).sum(w)
        return d

    # ------------------------------------------------------------------ #
    # reference-compatible mutating API
    # ------------------------------------------------------------------ #
    def update_bcs(self, t):
        self.update_dirichlet(t)
        self.update_neumann(t)
        self.update_robin(t)

    def update_dirichlet(self, t):
        self.mask, self.T_bc = self.dirichlet_arrays(t)

    def update_neumann(self, t):
        self.b_neumann = self.neumann_rhs(t)

    def update_robin(self, t):
        self.b_robin = self.robin_rhs(t)
