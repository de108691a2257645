"""Distributed data graph + distributed chromatic engine (paper §4), on
the port.

The port of ``repro.core.distributed``.  Host side, ``ShardPlan.build``
is the paper's load procedure: from a vertex -> machine assignment
(``partition.two_phase_partition`` or ``random_partition``) every shard
gets its owned vertices plus **ghosts** (the boundary vertices and edges
of its neighbours, §4.1 Fig. 4) and the static communication schedule:

* ``send/recv`` (per color): owned color-c vertices that peers ghost,
  pushed after phase c (the chromatic engine's ghost sync, §4.2.1);
* ``esend/erecv`` (per color): cut-edge data written by the color-c
  endpoint, pushed to the replica holder;
* ``tsend/trecv``: task-set backflow, ghost-row flags and priorities
  OR/max-combined into the owner's task set (the locking engine also
  uses this symmetric channel for its claim combine and its versioned
  ghost push);
* ``global_ids`` and ``cesend/cerecv``: the locking engine's
  partition-independent claim order and its color-free cut-edge push.

Every array is bitwise the reference's for the same graph and
assignment, split and unsplit.  The build is vectorized (sorted keys
and ``searchsorted`` where the reference loops over vertices and keeps
dicts), and each shard's sliced blocks come straight from the graph's
stored rows (``graph.row_slots``), never through ``[M, R, max_deg]``
padded arrays.

Device side, ``DistributedChromaticEngine`` runs the single-shard
engine's color phase on every shard (``exec.apply_batch`` on the
shard's ``LocalStruct``), then the ghost push, the optional edge push
and the task backflow through a ``repro_torch.core.mesh`` mesh:
per-shard compute -> pack -> exchange -> unpack.  Termination is a
``psum`` of the owned active counts read on the host once a superstep;
syncs fold each shard's owned rows, ``all_gather`` the partials and
merge them in shard order.  All shard shapes are uniform, as in the
reference.

Consistency: EDGE / VERTEX / UNSAFE (writes to self and adjacent
edges).  FULL-consistency neighbour writes would need ghost-data
backflow and are not supported across shards, as in the reference.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.exec import (NO_CLAIM, apply_batch, choose_dispatch,
                                   validate_dispatch)
from repro_torch.core.graph import (DataGraph, EllRows, SlicedEll,
                                    bucket_index, default_bucket_widths,
                                    row_slots, segment_index,
                                    sliced_ell_from_slots,
                                    sliced_slot_count, split_ell_from_slots,
                                    virtual_rows)
from repro_torch.core.mesh import LocalMesh
from repro_torch.core.registry import register_distributed
from repro_torch.core.sync import SyncOp, _leaves, tree_map
from repro_torch.core.update import UpdateFn

PyTree = Any


class LocalStruct(NamedTuple):
    """One shard's graph structure, with ``DataGraph``'s structure API
    (``struct_rows`` / ``degree`` / ``n_rows`` / ``ell``) over its
    local rows, so the executor core runs on it unchanged."""
    ell: SlicedEll
    degree: torch.Tensor
    n_vertices: int   # rows per shard R

    @property
    def n_rows(self) -> int:
        return self.n_vertices

    def struct_rows(self, ids: torch.Tensor,
                    width: int | None = None) -> EllRows:
        return self.ell.rows(ids, width=width)


def _group_ranks(keys: np.ndarray) -> np.ndarray:
    """Position of each entry within its run of equal ``keys`` (keys
    sorted, so every group is one run)."""
    if not len(keys):
        return np.zeros(0, np.int64)
    first = np.ones(len(keys), bool)
    first[1:] = keys[1:] != keys[:-1]
    start = np.nonzero(first)[0]
    run = np.cumsum(first) - 1
    return np.arange(len(keys)) - start[run]


def _width(ranks: np.ndarray) -> int:
    return max(1, int(ranks.max()) + 1 if len(ranks) else 1)


@dataclasses.dataclass
class ShardPlan:
    """Static distributed layout and communication schedule (host-built,
    numpy).  ``ells`` holds each shard's ``SlicedEll`` on the host; the
    engines copy a shard's blocks to its device."""
    M: int                 # number of shards
    R: int                 # rows per shard (owned + ghost + padding)
    E_loc: int             # local edges per shard (excl. pad row)
    n_colors: int
    Cmax: int              # color batch width
    Hv: int                # vertex-exchange width per (color, peer)
    He: int                # edge-exchange width per (color, peer)
    Hg: int                # task-backflow width per peer
    ell_widths: tuple      # bucket widths, shared by every shard
    ell_starts: tuple      # bucket position offsets, shared
    degree: np.ndarray      # [M, R] int32
    owned_mask: np.ndarray  # [M, R]
    color_ids: np.ndarray   # [M, n_colors, Cmax] local owned slots
    color_valid: np.ndarray
    send_idx: np.ndarray    # [M, n_colors, M, Hv] local owned slot to send
    send_mask: np.ndarray
    recv_idx: np.ndarray    # [M, n_colors, M, Hv] ghost slot to fill (pad R)
    esend_idx: np.ndarray   # [M, n_colors, M, He]
    esend_mask: np.ndarray
    erecv_idx: np.ndarray   # (pad E_loc)
    tsend_idx: np.ndarray   # [M, M, Hg] ghost slot whose flags go home
    tsend_mask: np.ndarray
    trecv_idx: np.ndarray   # [M, M, Hg] owner's owned slot (pad R)
    # ---- color-independent schedules (locking engine) ----
    Hc: int
    global_ids: np.ndarray  # [M, R] global vertex id (NO_CLAIM on pad rows)
    cesend_idx: np.ndarray  # [M, M, Hc] local edge slot pushed to the peer
    cesend_mask: np.ndarray
    cerecv_idx: np.ndarray  # [M, M, Hc] the peer's replica slot (pad E_loc)
    # ---- host-side maps ----
    local_to_global: np.ndarray  # [M, R] global vertex id or -1
    ledge_to_global: np.ndarray  # [M, E_loc] global edge id or -1
    assignment: np.ndarray       # [Nv]
    ells: tuple = ()             # each shard's SlicedEll (host)
    # ---- hub splitting: virtual rows are shard-local ----
    ell_max_deg: int | None = None       # owner-space width (D)
    ell_w_cap: int | None = None
    ell_n_chunks_max: int = 1

    # ------------------------------------------------------------------
    @staticmethod
    def build(graph: DataGraph, assignment: np.ndarray, M: int) -> "ShardPlan":
        nv, ne, D = graph.n_vertices, graph.n_edges, graph.max_deg
        # colorless graphs get the trivial single-color schedule (enough
        # for the locking engine, which ignores colors)
        colors = (graph.colors.cpu().numpy().astype(np.int64)
                  if graph.colors is not None else np.zeros(nv, np.int64))
        n_colors = int(colors.max()) + 1 if nv else 1
        assignment = np.asarray(assignment, dtype=np.int64)
        if assignment.shape != (nv,):
            raise ValueError(f"assignment must be [{nv}], got "
                             f"{assignment.shape}")
        if nv and (assignment.min() < 0 or assignment.max() >= M):
            raise ValueError(f"assignment values must lie in [0, {M})")
        edges = np.asarray(graph.edges_np, np.int64).reshape(-1, 2)
        eu, ev = edges[:, 0], edges[:, 1]
        au, av = assignment[eu], assignment[ev]
        eid = np.arange(ne, dtype=np.int64)

        # ---- owned rows: each shard's vertices in ascending id ----
        own_order = np.argsort(assignment, kind="stable")
        own_count = np.bincount(assignment, minlength=M)
        own_start = np.concatenate([[0], np.cumsum(own_count)[:-1]])
        own_slot = np.empty(nv, np.int64)
        own_slot[own_order] = (np.arange(nv)
                               - np.repeat(own_start, own_count))

        # ---- ghosts: (reader shard, foreign neighbour), sorted ----
        reader = np.concatenate([au, av])
        gv = np.concatenate([ev, eu])
        cut = assignment[gv] != reader
        gkey = np.unique(reader[cut] * nv + gv[cut])
        g_reader, g_v = gkey // max(nv, 1), gkey % max(nv, 1)
        ghost_count = np.bincount(g_reader, minlength=M)
        ghost_start = np.concatenate([[0], np.cumsum(ghost_count)[:-1]])
        O = max(1, int(own_count.max()) if M else 1)
        G = max(1, int(ghost_count.max()) if len(gkey) else 1)
        R = O + G
        g_slot = O + np.arange(len(gkey)) - ghost_start[g_reader]

        local_to_global = np.full((M, R), -1, dtype=np.int64)
        local_to_global[assignment, own_slot] = np.arange(nv)
        local_to_global[g_reader, g_slot] = g_v
        # global -> local rows of every shard (-1: not held there)
        g2l_map = np.full((M, nv), -1, dtype=np.int32)
        g2l_map[assignment, np.arange(nv)] = own_slot
        g2l_map[g_reader, g_v] = g_slot

        def g2l(shard, v):
            """Local row of vertex ``v`` on ``shard`` (owned or ghost)."""
            return g2l_map[shard, v]

        # ---- local edges: every edge incident to an owned vertex ----
        lkey = np.sort(np.concatenate([au * ne + eid,
                                       (av * ne + eid)[av != au]]))
        l_shard, l_e = lkey // max(ne, 1), lkey % max(ne, 1)
        l_count = np.bincount(l_shard, minlength=M)
        l_start = np.concatenate([[0], np.cumsum(l_count)[:-1]])
        E_loc = max(1, int(l_count.max()) if len(lkey) else 1)
        ledge_to_global = np.full((M, E_loc), -1, dtype=np.int64)
        ledge_to_global[l_shard, np.arange(len(lkey)) - l_start[l_shard]] = l_e

        e2l_map = np.full((M, ne), -1, dtype=np.int32)
        e2l_map[l_shard, l_e] = np.arange(len(lkey)) - l_start[l_shard]

        def e2l(shard, e):
            return e2l_map[shard, e]

        # ---- per-shard row slot lists for the owned rows ----
        cnt_g, (f_nbr, f_eid, f_src) = row_slots(graph.ell)
        ptr_g = np.concatenate([[0], np.cumsum(cnt_g)[:-1]]).astype(np.int64)
        h_deg = graph.degree.cpu().numpy()
        deg_l = np.zeros((M, R), dtype=np.int32)
        owned_mask = np.zeros((M, R), dtype=bool)
        deg_l[assignment, own_slot] = h_deg
        owned_mask[assignment, own_slot] = True
        shard_rows = []          # (seg_start [R], count [R], flat slots)
        for i in range(M):
            own = own_order[own_start[i]: own_start[i] + own_count[i]]
            cnt = np.zeros(R, np.int64)
            cnt[: len(own)] = cnt_g[own]
            idx = segment_index(ptr_g[own], cnt_g[own])
            flat = (g2l(i, f_nbr[idx].astype(np.int64)).astype(np.int32),
                    e2l(i, f_eid[idx].astype(np.int64)).astype(np.int32),
                    f_src[idx])
            seg = np.concatenate([[0], np.cumsum(cnt)[:-1]])
            shard_rows.append((seg, cnt, flat))

        # ---- per-color owned batches ----
        c_own = colors[own_order]
        ckey = assignment[own_order] * n_colors + c_own
        corder = np.argsort(ckey, kind="stable")
        ct = _group_ranks(ckey[corder])
        Cmax = _width(ct)
        color_ids = np.zeros((M, n_colors, Cmax), dtype=np.int32)
        color_valid = np.zeros((M, n_colors, Cmax), dtype=bool)
        cv = own_order[corder]
        color_ids[assignment[cv], colors[cv], ct] = own_slot[cv]
        color_valid[assignment[cv], colors[cv], ct] = True

        # ---- vertex ghost exchange (owner -> ghost), per color ----
        g_c, g_own = colors[g_v], assignment[g_v]
        skey = (g_reader * n_colors + g_c) * M + g_own
        sorder = np.argsort(skey, kind="stable")
        st = _group_ranks(skey[sorder])
        Hv = _width(st)
        send_idx = np.zeros((M, n_colors, M, Hv), dtype=np.int32)
        send_mask = np.zeros((M, n_colors, M, Hv), dtype=bool)
        recv_idx = np.full((M, n_colors, M, Hv), R, dtype=np.int32)
        i_, c_, j_, v_ = (g_reader[sorder], g_c[sorder], g_own[sorder],
                          g_v[sorder])
        send_idx[j_, c_, i_, st] = own_slot[v_]
        send_mask[j_, c_, i_, st] = True
        recv_idx[i_, c_, j_, st] = g_slot[sorder]

        # ---- cut-edge replica push (color-c endpoint owner -> peer) ----
        ecut = au != av
        ce, cu, cv_ = eid[ecut], eu[ecut], ev[ecut]
        e_c = np.concatenate([colors[cu], colors[cv_]])
        e_ow = np.concatenate([au[ecut], av[ecut]])
        e_peer = np.concatenate([av[ecut], au[ecut]])
        e_e = np.concatenate([ce, ce])
        ekey = (e_c * M + e_ow) * M + e_peer
        eorder = np.lexsort((e_e, ekey))
        et = _group_ranks(ekey[eorder])
        He = _width(et)
        esend_idx = np.zeros((M, n_colors, M, He), dtype=np.int32)
        esend_mask = np.zeros((M, n_colors, M, He), dtype=bool)
        erecv_idx = np.full((M, n_colors, M, He), E_loc, dtype=np.int32)
        c_, o_, p_, x_ = (e_c[eorder], e_ow[eorder], e_peer[eorder],
                          e_e[eorder])
        esend_idx[o_, c_, p_, et] = e2l(o_, x_)
        esend_mask[o_, c_, p_, et] = True
        erecv_idx[p_, c_, o_, et] = e2l(p_, x_)

        # ---- task backflow (ghost flags -> owner), color independent ----
        tkey = g_reader * M + g_own
        torder = np.argsort(tkey, kind="stable")
        tt = _group_ranks(tkey[torder])
        Hg = _width(tt)
        tsend_idx = np.zeros((M, M, Hg), dtype=np.int32)
        tsend_mask = np.zeros((M, M, Hg), dtype=bool)
        trecv_idx = np.full((M, M, Hg), R, dtype=np.int32)
        i_, j_ = g_reader[torder], g_own[torder]
        tsend_idx[i_, j_, tt] = g_slot[torder]
        tsend_mask[i_, j_, tt] = True
        trecv_idx[j_, i_, tt] = own_slot[g_v[torder]]

        # ---- color-independent cut-edge replica exchange (locking) ----
        # slot t of (iu -> iv) and of (iv -> iu) name the same edge: the
        # symmetry the all_to_all relies on
        xkey = e_ow * M + e_peer
        xorder = np.lexsort((e_e, xkey))
        xt = _group_ranks(xkey[xorder])
        Hc = _width(xt)
        cesend_idx = np.zeros((M, M, Hc), dtype=np.int32)
        cesend_mask = np.zeros((M, M, Hc), dtype=bool)
        cerecv_idx = np.full((M, M, Hc), E_loc, dtype=np.int32)
        o_, p_, x_ = e_ow[xorder], e_peer[xorder], e_e[xorder]
        cesend_idx[o_, p_, xt] = e2l(o_, x_)
        cesend_mask[o_, p_, xt] = True
        cerecv_idx[p_, o_, xt] = e2l(p_, x_)

        global_ids = np.where(local_to_global >= 0, local_to_global,
                              NO_CLAIM).astype(np.int32)

        # ---- degree-bucket each shard's rows, shapes uniform ----
        w_cap = graph.ell.w_cap
        if w_cap is not None:
            ells, n_chunks_max, kwidths = _split_shard_ells(
                shard_rows, D, E_loc, w_cap)
        else:
            n_chunks_max = 1
            widths_all = default_bucket_widths(D)
            counts = np.stack([np.bincount(bucket_index(widths_all, cnt),
                                           minlength=len(widths_all))
                               for _, cnt, _ in shard_rows])
            sizes_all = counts.max(axis=0)
            keep = [b for b in range(len(widths_all)) if sizes_all[b] > 0]
            kwidths = tuple(widths_all[b] for b in keep)
            ksizes = [int(sizes_all[b]) for b in keep]
            ells = tuple(
                dataclasses.replace(
                    sliced_ell_from_slots(seg, cnt, flat, E_loc, kwidths,
                                          D, bucket_sizes=ksizes,
                                          device="cpu"),
                    max_deg=kwidths[-1])
                for seg, cnt, flat in shard_rows)

        return ShardPlan(
            M=M, R=R, E_loc=E_loc, n_colors=n_colors, Cmax=Cmax,
            Hv=Hv, He=He, Hg=Hg, Hc=Hc,
            ell_widths=kwidths, ell_starts=tuple(ells[0].starts),
            degree=deg_l, owned_mask=owned_mask,
            color_ids=color_ids, color_valid=color_valid,
            send_idx=send_idx, send_mask=send_mask, recv_idx=recv_idx,
            esend_idx=esend_idx, esend_mask=esend_mask,
            erecv_idx=erecv_idx, tsend_idx=tsend_idx,
            tsend_mask=tsend_mask, trecv_idx=trecv_idx,
            global_ids=global_ids, cesend_idx=cesend_idx,
            cesend_mask=cesend_mask, cerecv_idx=cerecv_idx,
            local_to_global=local_to_global,
            ledge_to_global=ledge_to_global, assignment=assignment,
            ells=ells,
            ell_max_deg=int(D) if w_cap is not None else None,
            ell_w_cap=int(w_cap) if w_cap is not None else None,
            ell_n_chunks_max=n_chunks_max)

    # ------------------------------------------------------------------
    @property
    def partition_fingerprint(self) -> str:
        """Content hash of (M, assignment): the identity a sharded
        snapshot records, so a restore onto another partition is
        refused at load."""
        h = hashlib.sha256()
        h.update(str(self.M).encode())
        h.update(np.ascontiguousarray(self.assignment,
                                      dtype=np.int64).tobytes())
        return h.hexdigest()[:16]

    @property
    def sliced_slots(self) -> int:
        """Per-shard stored slot count ``sum_b R_b * W_b``."""
        return sliced_slot_count(self.ell_starts, self.ell_widths)

    @property
    def bucket_launches(self) -> tuple[tuple[int, int], ...]:
        """Per-shard ``(width, rows)`` launch sequence of one bucket
        sweep (the shards share it)."""
        return tuple(
            (int(self.ell_widths[b]),
             int(self.ell_starts[b + 1] - self.ell_starts[b]))
            for b in range(len(self.ell_widths)))

    def _stack(self, get) -> tuple:
        return tuple(np.stack([get(e, b).cpu().numpy() for e in self.ells])
                     for b in range(len(self.ell_widths)))

    def ell_arrays(self) -> dict:
        """The reference's stacked sliced-ELL arrays: per bucket
        ``[M, R_b, W_b]`` blocks, ``[M, ...]`` permutations (numpy)."""
        out = {f"ell_{f}": self._stack(lambda e, b, f=f: getattr(e, f)[b])
               for f in ("nbrs", "nbr_mask", "edge_ids", "is_src")}
        out.update(ell_perm=np.stack([e.perm.numpy() for e in self.ells]),
                   ell_inv_perm=np.stack([e.inv_perm.numpy()
                                          for e in self.ells]))
        if self.ell_w_cap is not None:
            out.update(
                ell_owner_of_vrow=np.stack([e.owner_of_vrow.numpy()
                                            for e in self.ells]),
                ell_vrow_offset=np.stack([e.vrow_offset.numpy()
                                          for e in self.ells]))
        return out

    def local_ell(self, shard: int, device) -> SlicedEll:
        """Shard ``shard``'s ``SlicedEll`` on ``device``."""
        return self.ells[shard].to(device)

    def local_struct(self, shard: int, device) -> LocalStruct:
        return LocalStruct(
            self.local_ell(shard, device),
            torch.from_numpy(self.degree[shard]).to(device), self.R)

    # ------------------------------------------------------------------
    def shard_vertex_data(self, vertex_data: PyTree,
                          shards: Sequence[int] | None = None) -> PyTree:
        """Global ``[Nv, ...]`` -> local ``[S, R, ...]`` for ``shards``
        (default: all M) — owned + ghost copies; float pad rows are
        zeroed by a multiply, as in the reference."""
        l2g = self.local_to_global[self._shard_ids(shards)]
        idx, msk = np.where(l2g >= 0, l2g, 0), l2g >= 0

        def shard(a):
            sel = torch.from_numpy(idx.reshape(-1)).to(a.device)
            out = a[sel].reshape(idx.shape + tuple(a.shape[1:]))
            if not out.dtype.is_floating_point:
                return out
            m = torch.from_numpy(msk).to(a.device, out.dtype)
            return out * m.reshape(idx.shape + (1,) * (a.dim() - 1))
        return tree_map(shard, vertex_data)

    def shard_edge_data(self, edge_data: PyTree,
                        shards: Sequence[int] | None = None) -> PyTree:
        """Global ``[Ne, ...]`` (no pad row) -> local ``[S, E_loc + 1,
        ...]`` for ``shards`` (default: all M), with a zero pad row."""
        l2g = self.ledge_to_global[self._shard_ids(shards)]
        idx = np.where(l2g >= 0, l2g, 0)

        def shard(a):
            sel = torch.from_numpy(idx.reshape(-1)).to(a.device)
            out = a[sel].reshape(idx.shape + tuple(a.shape[1:]))
            pad = out.new_zeros((len(idx), 1) + tuple(a.shape[1:]))
            return torch.cat([out, pad], dim=1)
        return tree_map(shard, edge_data)

    def _shard_ids(self, shards) -> np.ndarray:
        return np.arange(self.M) if shards is None \
            else np.asarray(shards, np.int64)

    def unshard_vertex_data(self, local: PyTree, n_vertices: int) -> PyTree:
        """Local ``[M, R, ...]`` -> global ``[Nv, ...]`` from owned rows."""
        src = np.nonzero(self.owned_mask.reshape(-1))[0]
        tgt = self.local_to_global.reshape(-1)[src]

        def unshard(a):
            flat = a.reshape((self.M * self.R,) + tuple(a.shape[2:]))
            out = flat.new_zeros((n_vertices,) + tuple(a.shape[2:]))
            return out.index_copy(
                0, torch.from_numpy(tgt).to(a.device),
                flat.index_select(0, torch.from_numpy(src).to(a.device)))
        return tree_map(unshard, local)


def _split_shard_ells(shard_rows, D: int, E_loc: int, w_cap: int):
    """Each shard's rows hub-split at ``w_cap`` (virtual rows stay
    shard-local): virtual-row count, chunk count and bucket sizes maxed
    over shards, dummy virtual rows (empty, owned by the R sentinel) in
    bucket 0."""
    widths_all = default_bucket_widths(w_cap)
    virt = [virtual_rows(seg, cnt, w_cap) for seg, cnt, _ in shard_rows]
    n_virt = max(len(v[1]) for v in virt)
    n_chunks_max = max(int((v[3][1:] - v[3][:-1]).max()) for v in virt)
    counts = np.zeros((len(virt), len(widths_all)), np.int64)
    for i, (_, vcnt, _, _) in enumerate(virt):
        counts[i] = np.bincount(bucket_index(widths_all, vcnt),
                                minlength=len(widths_all))
        counts[i, 0] += n_virt - len(vcnt)
    sizes_all = counts.max(axis=0)
    keep = [b for b in range(len(widths_all)) if sizes_all[b] > 0]
    kwidths = tuple(widths_all[b] for b in keep)
    ksizes = [int(sizes_all[b]) for b in keep]
    ells = tuple(
        dataclasses.replace(
            split_ell_from_slots(seg, cnt, flat, E_loc, w_cap, D,
                                 widths=kwidths, bucket_sizes=ksizes,
                                 n_virtual=n_virt, device="cpu"),
            n_chunks_max=n_chunks_max)
        for seg, cnt, flat in shard_rows)
    return ells, n_chunks_max, kwidths


# ----------------------------------------------------------------------
# Per-shard schedules on the device, and the exchanges built on them
# ----------------------------------------------------------------------

def _on(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device) if dtype is None else t.to(device, dtype)


def _received(idx: np.ndarray, bound: int, device):
    """The static half of an unpack: the flat positions of ``idx``'s
    real entries (``idx < bound``; padding holds ``bound``) and the local
    rows they land on.  Received rows are distinct, so an
    ``index_copy`` of them is exact."""
    flat = idx.reshape(-1)
    pos = np.nonzero(flat < bound)[0]
    return _on(pos, device, torch.long), _on(flat[pos], device, torch.long)


class ShardArrays:
    """One shard's plan arrays on its device, with the static unpack
    indices the exchanges use (where the reference drops padding writes
    out of range, the port writes only the real entries): the color
    schedules for the chromatic engine (``colored``), the color-free
    cut-edge channel for the locking engine, edges only where
    ``edges``."""

    def __init__(self, plan: ShardPlan, shard: int, device,
                 colored: bool = True, edges: bool = False):
        i, R = shard, plan.R
        self.device = device
        self.struct = plan.local_struct(i, device)
        self.owned = _on(plan.owned_mask[i], device)
        self.global_ids = _on(plan.global_ids[i], device)
        # backflow / claim / versioned channel (tsend <-> trecv)
        self.ts_idx = _on(plan.tsend_idx[i], device, torch.long)
        self.ts_mask = _on(plan.tsend_mask[i], device)
        self.ts_pos, self.ts_rows = _received(
            np.where(plan.tsend_mask[i], plan.tsend_idx[i], R), R, device)
        tr = plan.trecv_idx[i]
        self.tr_ok = _on(tr < R, device)
        self.tr_safe = _on(np.where(tr < R, tr, 0), device, torch.long)
        self.tr_pos, self.tr_rows = _received(tr, R, device)
        if colored:
            self.color_ids = _on(plan.color_ids[i], device)
            self.color_valid = _on(plan.color_valid[i], device)
            self.send = [_on(plan.send_idx[i, c].reshape(-1), device,
                             torch.long) for c in range(plan.n_colors)]
            self.recv = [_received(plan.recv_idx[i, c], R, device)
                         for c in range(plan.n_colors)]
            if edges:
                self.esend = [_on(plan.esend_idx[i, c].reshape(-1), device,
                                  torch.long) for c in range(plan.n_colors)]
                self.erecv = [_received(plan.erecv_idx[i, c], plan.E_loc,
                                        device)
                              for c in range(plan.n_colors)]
        if edges and not colored:
            self.ce_idx = _on(plan.cesend_idx[i], device, torch.long)
            self.ce_mask = _on(plan.cesend_mask[i], device)
            self.cr_pos, self.cr_rows = _received(plan.cerecv_idx[i],
                                                  plan.E_loc, device)


def push_rows(mesh, arrays: list, send: list, recv: list) -> list:
    """Owner -> replica push of one tensor a shard: shard ``i`` packs
    ``arrays[i][send[i]]`` as ``[M, H, ...]``, the mesh exchanges, and
    each shard writes the real received entries (``recv[i] = (pos,
    rows)``) into its rows.  Returns new tensors."""
    m = mesh.n_shards
    bufs = [a.index_select(0, s).reshape((m, -1) + tuple(a.shape[1:]))
            for a, s in zip(arrays, send)]
    outs = mesh.all_to_all(bufs)
    return [a.index_copy(0, rows, o.reshape((-1,) + tuple(a.shape[1:]))
                         .index_select(0, pos))
            for a, o, (pos, rows) in zip(arrays, outs, recv)]


def task_backflow(mesh, sa: list, active: list, priority: list):
    """Ghost-row task flags and priorities -> owner (OR / max), then the
    ghost copies cleared; flags travel as a float32 stack with the
    priority, so one ``all_to_all`` carries both.  Shared by the
    chromatic and locking engines."""
    bufs = []
    for s, act, pri in zip(sa, active, priority):
        flags = act[s.ts_idx] & s.ts_mask                 # [M, Hg]
        prios = torch.where(flags, pri[s.ts_idx], -torch.inf)
        bufs.append(torch.stack([flags.to(torch.float32), prios], -1))
    outs = mesh.all_to_all(bufs)
    new_a, new_p = [], []
    for s, act, pri, fb in zip(sa, active, priority, outs):
        fb = fb.reshape(-1, 2).index_select(0, s.tr_pos)
        inflag = fb[:, 0] > 0.5
        act = act.to(torch.int32).scatter_reduce(
            0, s.tr_rows, inflag.to(torch.int32), "amax").to(torch.bool)
        pri = pri.scatter_reduce(
            0, s.tr_rows, torch.where(inflag, fb[:, 1], -torch.inf), "amax")
        new_a.append(act.index_fill(0, s.ts_rows, False))
        new_p.append(pri)
    return new_a, new_p


def dist_refresh_syncs(mesh, syncs: Sequence[SyncOp], globals_: list,
                       vdata: list, owned: list, superstep: int) -> list:
    """Refresh every due sync op across shards: each shard folds its
    owned rows, the partials are ``all_gather``-ed, and each shard
    merges them in shard order (once for every distinct gathered
    tensor: shards sharing a device share the merge)."""
    new = [dict(g) for g in globals_]
    for s in syncs:
        if (superstep + 1) % max(s.tau, 1) != 0:
            continue
        parts = [s.local_reduce(vd, valid=ok) for vd, ok in zip(vdata, owned)]
        leaves = [_leaves(p) for p in parts]
        gathered = [mesh.all_gather([lv[k] for lv in leaves])
                    for k in range(len(leaves[0]))]
        done: dict = {}
        for i in range(len(parts)):
            key = tuple(id(g[i]) for g in gathered)
            if key not in done:
                def part(m):
                    it = iter([g[i][m] for g in gathered])
                    return tree_map(lambda _: next(it), parts[0])
                acc = part(0)
                for m in range(1, mesh.n_shards):
                    acc = s.merge(acc, part(m))
                done[key] = s.finalize(acc)
            new[i][s.key] = done[key]
    return new


def active_total(mesh, active: list, owned: list) -> int:
    """Owned active rows over every shard (a ``psum``, read on the
    host): the termination test."""
    counts = [(a & o).sum().reshape(1) for a, o in zip(active, owned)]
    return int(mesh.psum(counts)[0].item())


class _CarryEngine:
    """The carry API the distributed engines share: ``init_carry`` ->
    ``step_chunk`` ... -> ``finalize``, with ``run`` the whole of it.
    A carry is a dict with one entry a local shard (``mesh.shards``) for
    every per-shard field, the host ``superstep`` and each shard's
    ``globals``; the steps never modify a carry in place."""

    SHARDED = ("vertex_data", "edge_data", "active", "priority",
               "n_updates")

    def _setup_mesh(self):
        if self.mesh is None:
            self.mesh = LocalMesh(self.plan.M, [self.graph.device])
        if self.mesh.n_shards != self.plan.M:
            raise ValueError(f"need {self.plan.M} shards, the mesh has "
                             f"{self.mesh.n_shards}")

    def _base_carry(self, active) -> dict:
        # only the shards this process drives are cut out of the graph
        plan, nv, mine = self.plan, self.graph.n_vertices, self.mesh.shards
        vdata0 = plan.shard_vertex_data(self.graph.vertex_data, mine)
        edata0 = plan.shard_edge_data(
            {k: a[:-1] for k, a in self.graph.edge_data.items()}, mine)
        dev = self.graph.device
        if active is None:
            active = torch.ones(nv, dtype=torch.bool, device=dev)
        elif not isinstance(active, torch.Tensor):
            active = torch.from_numpy(np.asarray(active, bool))
        act0 = plan.shard_vertex_data({"a": active.to(dev, torch.bool)},
                                      mine)["a"]
        act0 = act0 & torch.from_numpy(plan.owned_mask[list(mine)]).to(dev)
        globals0 = {s.key: s.run(self.graph.vertex_data) for s in self.syncs}
        out = {k: [] for k in self.SHARDED + ("globals",)}
        for k, s in enumerate(self._sa):
            d = s.device
            out["vertex_data"].append({key: v[k].to(d) for key, v in
                                       vdata0.items()})
            out["edge_data"].append({key: v[k].to(d) for key, v in
                                     edata0.items()})
            out["active"].append(act0[k].to(d))
            out["priority"].append(act0[k].to(d, torch.float32))
            out["n_updates"].append(torch.zeros((), dtype=torch.int64,
                                                device=d))
            out["globals"].append(tree_map(lambda t: t.to(d), globals0))
        out["superstep"] = 0
        return out

    def carry_active_any(self, carry: dict) -> bool:
        return active_total(self.mesh, carry["active"],
                            [s.owned for s in self._sa]) > 0

    # set by repro_torch.ft.runner while a FaultPlan is active
    fault_hook = None

    def step_chunk(self, carry: dict, stop_at: int,
                   ignore_active: bool = False) -> dict:
        """Advance ``carry`` to superstep ``stop_at``, or until the task
        set drains (unless ``ignore_active``).  A chunked run is bitwise
        the whole ``run``: the same supersteps, cut elsewhere.

        ``fault_hook`` (``None`` unless ``repro_torch.ft.runner`` set
        one) fires once on the host at the chunk's first boundary,
        before any superstep runs; the supersteps never consult it."""
        if self.fault_hook is not None:
            self.fault_hook("superstep", superstep=int(carry["superstep"]))
        while carry["superstep"] < stop_at and (
                ignore_active or self.carry_active_any(carry)):
            carry = self._superstep(carry)
        return carry

    def _gather_local(self, tree_list: list) -> PyTree:
        """Per-local-shard trees -> ``[M, ...]`` stacks of every shard
        (an ``all_gather`` under a process group)."""
        first = tree_list[0]
        if isinstance(self.mesh, LocalMesh):
            dev = self._sa[0].device
            its = [iter(_leaves(t)) for t in tree_list]
            return tree_map(lambda _: torch.stack(
                [next(it).to(dev) for it in its]), first)
        its = iter(_leaves(first))
        return tree_map(lambda _: self.mesh.all_gather([next(its)])[0], first)

    def init_carry(self, active=None) -> dict:
        """The initial state: each local shard's owned and ghost rows,
        task set and priorities, and the globals."""
        return self._base_carry(active)

    def finalize(self, carry: dict) -> dict:
        plan = self.plan
        stacked = self._gather_local(carry["vertex_data"])
        n_upd = self.mesh.psum([n.reshape(1) for n in carry["n_updates"]])
        return dict(
            vertex_data=plan.unshard_vertex_data(stacked,
                                                 self.graph.n_vertices),
            local_vertex_data=carry["vertex_data"],
            local_edge_data=carry["edge_data"],
            globals=carry["globals"][0],
            supersteps=int(carry["superstep"]),
            n_updates=int(n_upd[0].item()),
            active_any=self.carry_active_any(carry))

    def run(self, active=None, num_supersteps: int | None = None) -> dict:
        carry = self.init_carry(active)
        if num_supersteps is not None:
            for _ in range(num_supersteps):
                carry = self._superstep(carry)
        else:
            carry = self.step_chunk(carry, self.max_supersteps)
        return self.finalize(carry)


# ======================================================================
@dataclasses.dataclass
class DistributedChromaticEngine(_CarryEngine):
    """Chromatic engine over a shard mesh (``LocalMesh`` on the graph's
    device unless ``mesh`` is given)."""

    graph: DataGraph
    plan: ShardPlan
    update_fn: UpdateFn
    syncs: Sequence[SyncOp] = ()
    max_supersteps: int = 100
    exchange_edges: bool = False   # app writes edge data on cut edges?
    use_kernel: bool = True        # aggregator kernel path on?
    # color phases sweep whole shards: per-bucket row launches
    dispatch: str | None = "bucket"
    cost_model: Any = None         # fitted launch-time model (auto)
    mesh: Any = None

    def __post_init__(self):
        validate_dispatch(self.dispatch)
        if self.graph.colors is None:
            raise ValueError("chromatic engine needs colors; call "
                             "graph.with_colors(...) (the locking engine "
                             "handles colorless graphs)")
        self._setup_mesh()
        self._sa = [ShardArrays(self.plan, i, self.mesh.device(i),
                                colored=True, edges=self.exchange_edges)
                    for i in self.mesh.shards]
        plan = self.plan
        self._mode = choose_dispatch(
            self.dispatch, plan.Cmax, plan.ell_widths[-1],
            plan.sliced_slots, cost_model=self.cost_model,
            bucket_launches=plan.bucket_launches)

    def _superstep(self, carry: dict) -> dict:
        sa, mesh = self._sa, self.mesh
        vdata, edata = list(carry["vertex_data"]), list(carry["edge_data"])
        active, priority = list(carry["active"]), list(carry["priority"])
        n_upd = list(carry["n_updates"])
        for c in range(self.plan.n_colors):
            for k, s in enumerate(sa):
                vdata[k], edata[k], active[k], priority[k], n_upd[k] = \
                    apply_batch(
                        s.struct, self.update_fn,
                        (vdata[k], edata[k], active[k], priority[k],
                         n_upd[k]),
                        s.color_ids[c], s.color_valid[c],
                        carry["globals"][k], use_kernel=self.use_kernel,
                        dispatch=self._mode)
            # ghost data push (owner -> ghost)
            for key in vdata[0]:
                new = push_rows(mesh, [v[key] for v in vdata],
                                [s.send[c] for s in sa],
                                [s.recv[c] for s in sa])
                vdata = [dict(v, **{key: x}) for v, x in zip(vdata, new)]
            if self.exchange_edges:
                for key in edata[0]:
                    new = push_rows(mesh, [e[key] for e in edata],
                                    [s.esend[c] for s in sa],
                                    [s.erecv[c] for s in sa])
                    edata = [dict(e, **{key: x}) for e, x in zip(edata, new)]
            active, priority = task_backflow(mesh, sa, active, priority)
        globals_ = dist_refresh_syncs(mesh, self.syncs, carry["globals"],
                                      vdata, [s.owned for s in sa],
                                      carry["superstep"])
        return dict(vertex_data=vdata, edge_data=edata, active=active,
                    priority=priority, n_updates=n_upd, globals=globals_,
                    superstep=carry["superstep"] + 1)


# the locking engine registers its own variant in
# repro_torch.core.engine_locking; the registry halves join at lookup
register_distributed("chromatic", DistributedChromaticEngine)
