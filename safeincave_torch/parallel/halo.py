"""Owned-node domain decomposition with neighbour-only halo exchange (port of
``safeincave_tpu/parallel/halo.py``).

The mesh is RCB-partitioned into spatially compact parts, each node is owned
by the first part that touches it, and the distributed stiffness action moves
only part-boundary rows between geometric neighbours:

    forward:  the directed neighbour graph {owner -> borrower} is
              edge-coloured into R rounds; in each round every part sends at
              most one neighbour the rows that neighbour borrows;
    element kernel: local gather -> dense -> local segment sum;
    reverse:  the same rounds, each pair reversed, ship the halo partial sums
              back to their owners, which add them into their owned rows.

The JAX package runs the parts on devices under one ``shard_map`` program
and a round is a ``ppermute``.  Here each rank of a multi-card run (W = 1
without a process group) holds D/W of the D parts, stacked on a leading axis
of tensors on its device: the body of the ``shard_map`` is a batched op over
that axis.  A round moves rows between two parts of one rank by one gather
and one ``index_add_`` over the flattened parts, and between two ranks by one
``batch_isend_irecv`` of the packed rows (:meth:`Comm.exchange`), which the
receiver adds into its slots; a ``psum`` is a sum over the axis and an
all-reduce over the ranks.  Every slot gets at most one nonzero add per
round, so a run repeats bit for bit, and with W = 1 it is the stacked
D-part program itself (the same partition, rounds and summation structure)
with the launches of one part.

All exchange tables are numpy, built once per (mesh, parts) by
:class:`HaloPlan`.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from .. import tracing
from ..fem.kernels import F32, F64, NodeGather, RankOps, element_stiffness
from ..fem.momentum import _blk_apply, _coarse_space
from ..mesh.native import morton_order, rcb_partition

# Voigt index of tensor entry (i, j), row-major, tensorial [xx yy zz xy xz yz]
_T2V = [0, 3, 4, 3, 1, 5, 4, 5, 2]


class HaloPlan:
    """Static partition and exchange tables of one (grid, nparts).

    Attributes (all numpy; D = nparts):
      elem_part (E,)        part of each element (RCB over centroids)
      owner (N,)            owning part of each node (first toucher in
                            part-major element order)
      node_perm (N,)        global node id -> padded slot d*S + local
      S, H, B               owned-block, halo-block and send-list sizes
                            (largest over the parts, at least 1)
      E_loc                 per-part element count (padded)
      R                     exchange rounds
      pair_send[r] (D, Bp_r)  local owned ids part d ships in round r
                              (pad: S, a zero row)
      pair_recv[r] (D, Bp_r)  halo slots part d fills in round r
                              (pad: H, the dump slot)
      perms[r]              the (src, dst) part pairs of round r
      round_sizes[r]        Bp_r
      conn_local (D,E_loc,4)   element nodes as local ids (owned block
                               [0, S), halo block [S, S+H))
      elem_pad (D, E_loc)   1.0 for real elements, 0.0 for padding
      elem_gids (D, E_loc)  global id of each local element (pad: 0)
      grad_N_local, vol_local  padded per-part geometry
    """

    def __init__(self, grid, nparts: int):
        conn = np.asarray(grid.conn)
        E, N = conn.shape[0], grid.n_nodes
        D = nparts
        parts, order = rcb_partition(grid.centroids, nparts)
        # elements grouped by part, padded to equal count
        elem_ids = [np.asarray(order)[parts[order] == d] for d in range(D)]
        self.E_loc = max(len(e) for e in elem_ids)

        # node ownership: first part (in part order) touching the node
        owner = np.full(N, -1, dtype=np.int64)
        for d in range(D):
            nodes_d = np.unique(conn[elem_ids[d]])
            fresh = nodes_d[owner[nodes_d] < 0]
            owner[fresh] = d
        if not (owner >= 0).all():
            raise ValueError("HaloPlan: the mesh has nodes no element "
                             "touches")
        self.owner = owner

        owned = [np.where(owner == d)[0] for d in range(D)]
        self.S = max(len(o) for o in owned)
        S = self.S
        node_perm = np.zeros(N, dtype=np.int64)
        for d in range(D):
            node_perm[owned[d]] = d * S + np.arange(len(owned[d]))
        self.node_perm = node_perm
        self.n_nodes = N
        self.D = D
        self.elem_part = parts

        # halo sets: nodes referenced locally but owned elsewhere
        halos = []
        for d in range(D):
            nodes_d = np.unique(conn[elem_ids[d]])
            halos.append(nodes_d[owner[nodes_d] != d])
        self.H = max((len(h) for h in halos), default=0)
        H = max(self.H, 1)
        self.H = H

        # send sets: owned nodes that appear in another part's halo
        send_sets = [[] for _ in range(D)]
        send_pos = {}
        for d in range(D):
            for gid in halos[d]:
                o = owner[gid]
                if gid not in send_pos:
                    send_pos[gid] = (o, len(send_sets[o]))
                    send_sets[o].append(gid)
        self.B = max((len(s) for s in send_sets), default=0)
        B = max(self.B, 1)
        self.B = B

        send_idx = np.zeros((D, B), dtype=np.int64)
        for d in range(D):
            for i, gid in enumerate(send_sets[d]):
                send_idx[d, i] = node_perm[gid] - d * S   # local owned id
        self.send_idx = send_idx

        halo_local_id = []   # per part: gid -> local id (S + h)
        for d in range(D):
            halo_local_id.append({gid: S + h
                                  for h, gid in enumerate(halos[d])})

        # ---- neighbour exchange rounds (edge colouring) ------------------ #
        # directed pairs owner -> borrower with the rows each pair carries
        pairs = {}               # (o, d) -> list of (send_local_on_o, slot_h)
        for d in range(D):
            for h, gid in enumerate(halos[d]):
                o = owner[gid]
                pairs.setdefault((o, d), []).append(
                    (node_perm[gid] - o * S, h))
        # greedy colouring, largest pairs first: per round each part sends
        # to at most one neighbour and receives from at most one.  The order
        # (a stable sort over the dict's insertion order) is the JAX
        # package's, so the tables come out equal.
        rounds = []              # list of {(o, d): rows}
        for (o, d), rows in sorted(pairs.items(),
                                   key=lambda kv: -len(kv[1])):
            for rd in rounds:
                if (not any(oo == o for (oo, _) in rd)
                        and not any(dd == d for (_, dd) in rd)):
                    rd[(o, d)] = rows
                    break
            else:
                rounds.append({(o, d): rows})
        self.R = len(rounds)

        # per-round tables, each as wide as its largest pair
        self.pair_send = []
        self.pair_recv = []
        self.perms = []
        self.round_sizes = []
        for rd in rounds:
            Bp_r = max(len(rows) for rows in rd.values())
            ps = np.full((D, Bp_r), S, dtype=np.int64)
            pr = np.full((D, Bp_r), H, dtype=np.int64)
            perm = []
            for (o, d), rows in sorted(rd.items()):
                perm.append((o, d))
                for i, (sid, h) in enumerate(rows):
                    ps[o, i] = sid
                    pr[d, i] = h
            self.pair_send.append(ps)
            self.pair_recv.append(pr)
            self.perms.append(perm)
            self.round_sizes.append(Bp_r)
        self.recv_rows_true = np.array(
            [sum(len(rows) for (o, dd), rows in pairs.items() if dd == d)
             for d in range(D)], dtype=np.int64)
        self.sent_rows_true = np.array(
            [sum(len(rows) for (oo, d2), rows in pairs.items() if oo == d)
             for d in range(D)], dtype=np.int64)
        self.recv_rows_padded = np.array(
            [sum(sz for rd, sz in zip(rounds, self.round_sizes)
                 for (o, dd) in rd if dd == d)
             for d in range(D)], dtype=np.int64)

        # local connectivity in local ids
        conn_local = np.zeros((D, self.E_loc, 4), dtype=np.int32)
        elem_pad = np.zeros((D, self.E_loc), dtype=np.float64)
        self.elem_gids = np.zeros((D, self.E_loc), dtype=np.int64)
        for d in range(D):
            tbl = halo_local_id[d]
            for k, e in enumerate(elem_ids[d]):
                for a in range(4):
                    gid = conn[e, a]
                    conn_local[d, k, a] = (node_perm[gid] - d * S
                                           if owner[gid] == d else tbl[gid])
                elem_pad[d, k] = 1.0
                self.elem_gids[d, k] = e
        self.conn_local = conn_local
        self.elem_pad = elem_pad

        # padded per-part geometry
        self.grad_N_local = np.zeros((D, self.E_loc, 4, 3))
        self.vol_local = np.zeros((D, self.E_loc))
        for d in range(D):
            n_e = len(elem_ids[d])
            self.grad_N_local[d, :n_e] = grid.grad_N[elem_ids[d]]
            self.vol_local[d, :n_e] = grid.volumes[elem_ids[d]]

    # -- diagnostics ------------------------------------------------------ #
    def comm_volume_per_matvec(self) -> int:
        """Rows received per part per matvec (forward; the reverse pass
        moves the same rows back): the true neighbour-interface rows, each
        round padded to its largest pair."""
        return int(self.recv_rows_padded.max(initial=0))

    def comm_rows_true(self) -> int:
        """True (unpadded) max neighbour-interface rows received per part."""
        return int(self.recv_rows_true.max(initial=0))

    def interface_fraction(self) -> float:
        """Communicated rows / total owned rows."""
        return self.D * self.comm_volume_per_matvec() / float(self.n_nodes)


def _round_tables(plan, reverse, first=0, n_local=None):
    """Per round, the exchange of the parts [first, first + n_local) one
    rank holds (all D by default), stacked: (flat gather index, flat add
    index, sends, recvs).  Forward: rows of the (n_local, S+1) owned block
    (row S is zero) into the (n_local, H+1) halo block; reverse: rows of the
    halo block (row H is zero) into the (n_local, S+1) owner accumulator.
    The gather and add serve the pairs within the rank; a part whose source
    in the round is elsewhere, or that receives nothing, gathers its own
    zero row, as a ``ppermute`` hands a part without a source zeros.
    ``sends`` and ``recvs`` list (peer rank, flat row index) for the pairs
    between ranks, each peer's pairs packed in the round's pair order: the
    rows to send, and the slots the received rows are added into."""
    D, S, H = plan.D, plan.S, plan.H
    n_local = D if n_local is None else n_local
    last = first + n_local
    loc = np.arange(first, last)
    out = []
    for ps, pr, perm in zip(plan.pair_send, plan.pair_recv, plan.perms):
        if reverse:
            src_tbl, dst_tbl, n_src, n_dst = pr, ps, H + 1, S + 1
            pairs = [(d, o, o) for (o, d) in perm]
        else:
            src_tbl, dst_tbl, n_src, n_dst = ps, pr, S + 1, H + 1
            pairs = [(o, d, o) for (o, d) in perm]
        src_of = np.arange(D)
        has = np.zeros(D, dtype=bool)
        for s, d, _ in pairs:
            src_of[d], has[d] = s, True
        own = has[loc] & (src_of[loc] >= first) & (src_of[loc] < last)
        src = np.where(own, src_of[loc], loc)
        gather = (src - first)[:, None] * n_src + np.where(
            own[:, None], src_tbl[src], n_src - 1)
        add = np.arange(n_local)[:, None] * n_dst + dst_tbl[loc]
        sends, recvs = {}, {}
        for s, d, owner in pairs:
            k = int((ps[owner] != S).sum())      # the pair's true rows
            s_in, d_in = first <= s < last, first <= d < last
            if s_in and not d_in:
                sends.setdefault(int(d) // n_local, []).append(
                    (s - first) * n_src + src_tbl[s, :k])
            elif d_in and not s_in:
                recvs.setdefault(int(s) // n_local, []).append(
                    (d - first) * n_dst + dst_tbl[d, :k])
        out.append((gather.reshape(-1), add.reshape(-1),
                    [(p, np.concatenate(v)) for p, v in sorted(sends.items())],
                    [(p, np.concatenate(v)) for p, v in sorted(recvs.items())]))
    return out


class HaloMomentumSolver(RankOps):
    """Distributed masked stiffness action and layout maps over a part
    mesh.

    ``matvec_padded`` works on owner-blocked (D_loc*S, 3) vectors, the
    owned rows of this rank's D_loc parts; ``to_padded`` and
    ``from_padded`` move between that layout and the global (n_nodes, 3)
    one, which is whole on every rank.  Element tangents (the rank's block
    of the element-sharded layout) go to the parts in local element order
    through ``ct_to_local`` once per linearized solve.  Every tensor lives
    on this rank's device with the part axis leading; ``dot`` is the
    all-reduced inner product of owner-blocked vectors.
    """

    def __init__(self, grid, mesh, plan: HaloPlan | None = None,
                 axis: str = "e"):
        D = mesh.n_parts
        self.grid = grid
        self.plan = plan or HaloPlan(grid, D)
        plan = self.plan
        if plan.D != D:
            raise ValueError(f"plan has {plan.D} parts, the mesh {D}")
        self.mesh = mesh
        self.axis = axis
        self.device = dev = mesh.device
        self.comm, self.world = mesh.comm, mesh.world
        self.D_loc = Dl = mesh.parts_per_rank
        self.first_part = p0 = mesh.first_part
        parts = slice(p0, p0 + Dl)
        self.S = S = plan.S
        self.H = H = plan.H
        self.L = L = S + H + 1           # + the dump row of the reverse pads

        def put(a, dtype=F64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        self.conn_local = put(plan.conn_local[parts], torch.int64)
        self.grad_N_local = put(plan.grad_N_local[parts])
        self.vol_local = put((plan.vol_local * plan.elem_pad)[parts])
        self.grad_N_local32 = self.grad_N_local.to(F32)
        self.vol_local32 = self.vol_local.to(F32)
        self.pair_send = tuple(put(a, torch.int64) for a in plan.pair_send)
        self.pair_recv = tuple(put(a, torch.int64) for a in plan.pair_recv)
        self.node_perm = put(plan.node_perm, torch.int64)
        # this rank's owned nodes and their rows of its owner blocks
        own_nodes = np.nonzero((plan.owner >= p0)
                               & (plan.owner < p0 + Dl))[0]
        self._own_rows = put(plan.node_perm[own_nodes] - p0 * S,
                             torch.int64)
        self._own_nodes = (None if self.world == 1
                           else put(own_nodes, torch.int64))
        self.elem_gids_flat = put(plan.elem_gids[parts].reshape(-1),
                                  torch.int64)
        self.elem_pad_flat = put(plan.elem_pad[parts].reshape(-1))

        def tables(reverse):
            return [(put(g, torch.int64), put(a, torch.int64),
                     [(p, put(i, torch.int64)) for p, i in snd],
                     [(p, put(i, torch.int64)) for p, i in rcv])
                    for g, a, snd, rcv in _round_tables(plan, reverse, p0,
                                                        Dl)]
        self._fwd, self._rev = tables(False), tables(True)
        # element nodes as rows of the flattened (D_loc*L) local blocks, and
        # the deterministic local segment sums (a gather and a row
        # reduction: index_add_ is atomic on CUDA)
        keys = (np.arange(Dl)[:, None, None] * L
                + plan.conn_local[parts].astype(np.int64))
        self._conn_flat = put(keys, torch.int64)
        self._seg = NodeGather.build(keys.reshape(-1), Dl * L, dev)

    # -- communication between the ranks ----------------------------------- #
    def dot(self, a, b):
        """<a, b> of owner-blocked vectors over every part: this rank's
        dot, all-reduced."""
        return self.global_sum(torch.dot(a.reshape(-1), b.reshape(-1)))

    def rows_sent_per_matvec(self) -> int:
        """Rows this rank sends to other ranks per matvec, forward and
        reverse (0 on one rank)."""
        return sum(int(i.numel()) for tbl in (self._fwd, self._rev)
                   for _, _, snd, _ in tbl for _, i in snd)

    def _round(self, dst, src, table):
        """One round: the pairs within the rank by a gather and an
        ``index_add_``, then the pairs between ranks by one exchange whose
        received rows are added into their slots."""
        gather, add, sends, recvs = table
        dst.index_add_(0, add, src[gather])
        if sends or recvs:
            bufs = self.comm.exchange(
                [(p, src[i]) for p, i in sends],
                [(p, (i.numel(), *src.shape[1:]), src.dtype)
                 for p, i in recvs])
            for (_, i), buf in zip(recvs, bufs):
                dst.index_add_(0, i, buf)

    # -- exchange --------------------------------------------------------- #
    def _fwd_exchange(self, u_own):
        """Neighbour rounds: the (D_loc, H+1, 3) halo rows (+ dump slot) of
        the owned rows u_own (D_loc, S, 3)."""
        D = u_own.shape[0]
        u_ext = torch.cat([u_own, u_own.new_zeros((D, 1, 3))], 1)
        u_ext = u_ext.reshape(-1, 3)
        halo = u_own.new_zeros((D * (self.H + 1), 3))
        for table in self._fwd:
            self._round(halo, u_ext, table)
        return halo.reshape(D, self.H + 1, 3)

    def _rev_exchange(self, f_halo, tail):
        """Reverse rounds: ship the halo partial sums f_halo (D_loc, H+1,
        *tail), dump slot zero, back to their owners; returns the owners'
        (D_loc, S, *tail) accumulation."""
        D = f_halo.shape[0]
        src = f_halo.reshape((-1, *tail))
        back = f_halo.new_zeros((D * (self.S + 1), *tail))
        for table in self._rev:
            self._round(back, src, table)
        return back.reshape((D, self.S + 1, *tail))[:, :self.S]

    # -- element kernels -------------------------------------------------- #
    def _matvec(self, CT_l, u_own, mask_own, gN, vol):
        """Per part: mask, borrow the halo, element action, local sums,
        return the halo partials; (D, S, 3)."""
        D, S = u_own.shape[0], self.S
        u_own = u_own * mask_own
        halo = self._fwd_exchange(u_own)
        u_loc = torch.cat([u_own, halo], 1).reshape(-1, 3)   # dump = row S+H
        ue = u_loc[self._conn_flat]                          # (D, E_loc, 4, 3)
        grad_u = torch.einsum("deai,deaj->deij", ue, gN)
        ev = torch.stack([grad_u[..., 0, 0], grad_u[..., 1, 1],
                          grad_u[..., 2, 2],
                          0.5 * (grad_u[..., 0, 1] + grad_u[..., 1, 0]),
                          0.5 * (grad_u[..., 0, 2] + grad_u[..., 2, 0]),
                          0.5 * (grad_u[..., 1, 2] + grad_u[..., 2, 1])], -1)
        sv = torch.einsum("deij,dej->dei", CT_l, ev)
        sig = torch.stack([sv[..., k] for k in _T2V], -1)
        sig = sig.reshape(*sv.shape[:-1], 3, 3)
        fe = torch.einsum("deij,deaj,de->deai", sig, gN, vol)
        f_loc = self._seg.sum(fe, (3,)).reshape(D, self.L, 3)
        back = self._rev_exchange(f_loc[:, S:], (3,))
        return (f_loc[:, :S] + back) * mask_own

    def _blockdiag(self, CT_l):
        """Nodal 3x3 diagonal blocks, owner-assembled through the same
        reverse exchange as the matvec; (D, S, 3, 3)."""
        D, S = CT_l.shape[0], self.S
        gN, vol = self.grad_N_local, self.vol_local
        E3 = torch.eye(3, dtype=gN.dtype, device=gN.device)
        gi = gN[..., None, :]                                # (D,E,4,1,3)
        ei = E3                                              # (3, 3)
        xx = ei[:, 0] * gi[..., 0]
        yy = ei[:, 1] * gi[..., 1]
        zz = ei[:, 2] * gi[..., 2]
        xy = 0.5 * (ei[:, 0] * gi[..., 1] + ei[:, 1] * gi[..., 0])
        xz = 0.5 * (ei[:, 0] * gi[..., 2] + ei[:, 2] * gi[..., 0])
        yz = 0.5 * (ei[:, 1] * gi[..., 2] + ei[:, 2] * gi[..., 1])
        eps6 = torch.stack([xx, yy, zz, xy, xz, yz], -1)     # (D,E,4,3,6)
        sig6 = torch.einsum("dekl,deajl->deajk", CT_l, eps6)
        w = torch.tensor([1., 1., 1., 2., 2., 2.], dtype=gN.dtype,
                         device=gN.device)
        blk = torch.einsum("deajk,deaik,k,de->deaij", sig6, eps6, w, vol)
        d_loc = self._seg.sum(blk, (3, 3)).reshape(D, self.L, 3, 3)
        back = self._rev_exchange(d_loc[:, S:], (3, 3))
        return d_loc[:, :S] + back

    # -- layout conversion (outside the Krylov loop) ----------------------- #
    def to_padded(self, v):
        """(n_nodes, ...) global -> (D_loc*S, ...) owner-blocked layout."""
        out = v.new_zeros((self.D_loc * self.S, *v.shape[1:]))
        out[self._own_rows] = v if self._own_nodes is None \
            else v[self._own_nodes]
        return out

    def from_padded(self, vp):
        """(D_loc*S, ...) -> (n_nodes, ...), the owned rows of every rank
        gathered."""
        if self.comm is not None and self.world > 1:
            vp = self.comm.all_gather(vp)
        return vp[self.node_perm]

    pad_rows = to_padded

    def ct_to_local(self, CT):
        """Tangents (E, 6, 6) in the element-sharded layout (this rank's
        block; ``E`` may carry element padding) -> (D_loc, E_loc, 6, 6) in
        each part's local element order, zero on padded local elements."""
        CT = torch.as_tensor(CT, device=self.device)
        return self.ct_to_local_traced(CT)

    def ct_to_local_traced(self, CT):
        """:meth:`ct_to_local` of a tensor already on the device: one
        all-gather over the ranks and one gather per linearized solve, not
        per matvec."""
        CT = self.gather_elems(CT)
        pad = self.elem_pad_flat.to(CT.dtype)
        CT_l = CT[self.elem_gids_flat] * pad[:, None, None]
        return CT_l.reshape(self.D_loc, -1, 6, 6)

    def _geom(self, dtype):
        if dtype == F32:
            return self.grad_N_local32, self.vol_local32
        return self.grad_N_local, self.vol_local

    def matvec_padded(self, CT_local, u_pad, mask_pad):
        """Distributed masked A @ u on (D_loc*S, 3) vectors; CT_local from
        :meth:`ct_to_local`."""
        return self.matvec_pad(CT_local, u_pad, mask_pad)

    def matvec_pad(self, CT_local, u_pad, mask_pad):
        """Dtype-polymorphic distributed masked A @ u (padded layout): the
        geometry twin of u's dtype."""
        D, S = self.D_loc, self.S
        gN, vol = self._geom(u_pad.dtype)
        out = self._matvec(CT_local, u_pad.reshape(D, S, 3),
                           mask_pad.reshape(D, S, 3), gN, vol)
        return out.reshape(D * S, 3)

    def block_diagonal_padded(self, CT_local):
        """Owner-assembled nodal 3x3 stiffness blocks, (D_loc*S, 3, 3)."""
        return self._blockdiag(CT_local).reshape(self.D_loc * self.S, 3, 3)


def make_halo_masked_solver(halo: HaloMomentumSolver, settings, apply_M,
                            zero_dirichlet: bool = False):
    """Halo-layout counterpart of ``fem.momentum._make_masked_solver``:
    ``solve_lin(CT, b, mask, u_bc, x0, rtol, P) -> (x, iters, res,
    b_eff_norm)`` with CT in global element order and nodal vectors in the
    global (n_nodes, 3) layout; everything inside the Krylov loop runs on
    the owner-blocked layout, converted once per solve.  ``P`` holds the
    padded preconditioner arrays.  When the mixed passes stall above the
    target, the solve finishes in f64 from the best mixed iterate and keeps
    the smaller residual."""
    from ..fem.solvers import ir_solve

    solve = settings.solve_fn()
    mixed = settings.precision == "mixed"

    def solve_lin(CT, b, mask, u_bc, x0, rtol, P):
        CT_l = halo.ct_to_local_traced(CT.to(F64))
        bp, mp = halo.to_padded(b), halo.to_padded(mask)
        up, x0p = halo.to_padded(u_bc), halo.to_padded(x0)

        def Aop(x):
            return mp * halo.matvec_pad(CT_l, mp * x, mp) + (1.0 - mp) * x

        def M_inv(r):
            return apply_M(P, r, mp)

        if zero_dirichlet:
            b_eff = mp * bp
        else:
            b_eff = (mp * (bp - halo.matvec_pad(CT_l, up, mp))
                     + (1.0 - mp) * up)
        b_eff_norm = torch.sqrt(halo.dot(b_eff, b_eff))
        if not mixed:
            x, k, res = solve(Aop, b_eff, x0p, M_inv, rtol=rtol,
                              maxiter=settings.max_it, dot=halo.dot)
            return halo.from_padded(x), k, res, b_eff_norm

        CT_l32 = CT_l.to(F32)
        mp32 = mp.to(F32)

        def Aop32(x):
            return (mp32 * halo.matvec_pad(CT_l32, mp32 * x, mp32)
                    + (1.0 - mp32) * x)

        def M_inv32(r):
            return apply_M(P, r, mp32)

        x, k, res = ir_solve(Aop, Aop32, b_eff, x0p, M_inv32,
                             inner_solve=solve, rtol=rtol,
                             inner_rtol=settings.inner_rtol,
                             inner_maxiter=settings.max_it,
                             max_passes=settings.max_passes, dot=halo.dot)
        res_h = tracing.read(res)
        if res_h > rtol * tracing.read(b_eff_norm):
            x2, k2, res2 = solve(Aop, b_eff, x, M_inv, rtol=rtol,
                                 maxiter=settings.max_it, dot=halo.dot)
            k += k2
            res2_h = tracing.read(res2)
            if math.isfinite(res2_h) and res2_h < res_h:
                x, res = x2, res2
        return halo.from_padded(x), k, res, b_eff_norm

    return solve_lin


def make_halo_solve32(halo: HaloMomentumSolver, settings, apply_M,
                      zero_dirichlet: bool = False):
    """Halo-layout counterpart of ``fem.momentum._make_solve32`` (the f32
    sweep's solve): defect correction, at most 4 passes, on the f32 tangent
    CT in global element order (the sharded kernel's ``prep`` is the
    identity), residuals in f64 on the owner-blocked layout.  Returns f32
    ``x`` and ``res``."""
    from ..fem.solvers import ir_solve

    solve = settings.solve_fn()

    def solve32(CT, b, x0, rtol, mask32, ubc32, P):
        CT_l64 = halo.ct_to_local_traced(CT.to(F64))
        CT_l32 = CT_l64.to(F32)
        mp = halo.to_padded(mask32.to(F64))
        mp32 = mp.to(F32)
        up64 = halo.to_padded(ubc32.to(F64))
        bp = halo.to_padded(b.to(F64))
        x0p = halo.to_padded(x0.to(F64))

        def Aop_hi(x):
            return mp * halo.matvec_pad(CT_l64, mp * x, mp) + (1.0 - mp) * x

        def Aop_lo(x):
            return (mp32 * halo.matvec_pad(CT_l32, mp32 * x, mp32)
                    + (1.0 - mp32) * x)

        def M_inv(r):
            return apply_M(P, r, mp32)

        if zero_dirichlet:
            b_eff = mp * bp
        else:
            b_eff = (mp * (bp - halo.matvec_pad(CT_l64, up64, mp))
                     + (1.0 - mp) * up64)
        x, k, res = ir_solve(Aop_hi, Aop_lo, b_eff, x0p, M_inv,
                             inner_solve=solve, rtol=rtol,
                             inner_rtol=settings.inner_rtol,
                             inner_maxiter=settings.max_it, max_passes=4,
                             dot=halo.dot)
        return halo.from_padded(x).to(F32), k, res.to(F32)

    return solve32


def halo_block_jacobi(halo: HaloMomentumSolver, C, mask):
    """Padded block-Jacobi preconditioner (P, apply) for the halo solver:
    blocks owner-assembled through the reverse exchange, masked, inverted
    per node.  ``apply`` takes padded residuals."""
    from ..linalg import inv3x3

    C_l = halo.ct_to_local(torch.as_tensor(C, dtype=F64))
    blk = halo.block_diagonal_padded(C_l)
    mp = halo.to_padded(torch.as_tensor(mask, dtype=F64, device=halo.device))
    eye = torch.eye(3, dtype=F64, device=halo.device)[None]
    blk = blk * mp[:, :, None] * mp[:, None, :]
    # padded and Dirichlet rows: identity keeps the blocks invertible
    blk = blk + (1.0 - mp)[:, :, None] * eye
    diag_ok = (blk[:, 0, 0].abs() + blk[:, 1, 1].abs()
               + blk[:, 2, 2].abs()) > 0
    blk = torch.where(diag_ok[:, None, None], blk, eye)
    blk_inv = inv3x3(blk)

    def apply_bj(P, r, m):
        (inv,) = P
        return _blk_apply(inv, r)

    return (blk_inv,), apply_bj


def halo_two_level(halo: HaloMomentumSolver, C, mask, G: int = 16):
    """Two-level preconditioner for the halo solver: the owner-local
    block-Jacobi smoother plus a dense coarse correction shared by every
    part.

    The aggregates are G consecutive nodes in Morton order of the node
    points, whatever the mesh's numbering (the restriction is a segment sum
    over a static table, so compact aggregates cost nothing).  The coarse
    matrix R A R^T is assembled once per wiring from the elastic element
    stiffness of the unpadded mesh (``C`` gathered from every rank) and
    inverted in f32 (``fem.momentum._coarse_space``) on rank 0, which
    broadcasts it.
    Each apply restricts this rank's rows and all-reduces the (n_agg, 3)
    coarse residual."""
    grid = halo.grid
    (blk_inv,), _ = halo_block_jacobi(halo, C, mask)

    node_morton = np.asarray(morton_order(np.asarray(grid.points)))
    agg_of_node = np.empty(grid.n_nodes, dtype=np.int64)
    agg_of_node[node_morton] = np.arange(grid.n_nodes, dtype=np.int64) // G

    grad_N, vol = np.asarray(grid.grad_N), np.asarray(grid.volumes)
    kern_view = SimpleNamespace(
        n_nodes=grid.n_nodes, device=halo.device,
        conn_np=np.asarray(grid.conn, dtype=np.int64),
        element_stiffness=lambda C_: element_stiffness(grad_N, vol, C_))
    C = halo.gather_elems(C)
    C_np = C.cpu().numpy() if isinstance(C, torch.Tensor) else np.asarray(C)
    mask_np = (mask.cpu().numpy() if isinstance(mask, torch.Tensor)
               else np.asarray(mask))
    # C may carry the element padding of shard_equation: the coarse
    # assembly runs on the real mesh
    coarse_inv, n_agg, _ = halo.from_rank0(lambda: _coarse_space(
        kern_view, C_np[:grid.n_elems], mask_np.astype(np.float64), G,
        agg_of_node=agg_of_node))

    # padded row -> aggregate (padding rows to a dump slot n_agg), this
    # rank's rows
    S = halo.S
    agg_pad = np.full(halo.plan.D * S, n_agg, dtype=np.int64)
    agg_pad[halo.plan.node_perm] = agg_of_node
    agg_pad = agg_pad[halo.first_part * S:(halo.first_part + halo.D_loc) * S]
    restrict = NodeGather.build(agg_pad, n_agg + 1, halo.device)
    agg_gather = torch.as_tensor(np.minimum(agg_pad, n_agg - 1),
                                 device=halo.device)

    def apply_2l(P, r, m):
        blk_inv, coarse_inv = P
        z = _blk_apply(blk_inv, r)
        rm = r * m     # padding rows carry m = 0: the dump slot is inert
        rc = halo.global_sum(restrict.sum(rm, (3,))[:n_agg])
        zc = (coarse_inv @ rc.reshape(-1).to(F32)).reshape(n_agg, 3)
        return z + zc[agg_gather].to(r.dtype) * m

    return (blk_inv, coarse_inv), apply_2l
