"""Shared executor core: one engine skeleton, many scheduling strategies.

The port of ``repro.core.exec`` for the bucket dispatch path:

* ``EngineState`` / ``init_engine_state`` — the engine state, a
  dataclass of tensors (``superstep`` is a host int: the host loop
  counts it);
* ``consume_and_reschedule`` — the task-set algebra.  Torch scatters
  have no ``mode="drop"``; each scatter takes only its selected entries
  (a boolean-mask compaction) instead of routing the others to an
  out-of-range row;
* ``dispatch_update`` — scope materialization and update dispatch:
  dense scopes, or the aggregator fast path through the ``ell_spmv``
  CUDA kernel, one launch over every degree bucket (one for each 16
  non-empty buckets);
* ``apply_batch`` / ``refresh_syncs`` — one conflict-free batch end to
  end, and the periodic sync refresh;
* ``ExecutorCore`` — a host loop over supersteps that ends when the
  task set drains or ``max_supersteps`` is reached.  A concrete engine
  implements only ``select``: which conflict-free batch runs in phase c.

The batch-shaped dispatch (``choose_dispatch``,
``switch_on_window_width``), the locking claim pass and hub splitting
are not ported yet (ROADMAP A4, A6).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.graph import DataGraph
from repro_torch.core.sync import SyncOp
from repro_torch.core.update import UpdateFn, gather_scopes, scatter_result
from repro_torch.kernels.ell_spmv import ell_fold_bucketed, ell_spmv_bucketed


# ----------------------------------------------------------------------
# Engine state
# ----------------------------------------------------------------------

@dataclasses.dataclass
class EngineState:
    vertex_data: dict
    edge_data: dict
    active: torch.Tensor        # [Nv] bool — the task set T
    priority: torch.Tensor      # [Nv] f32  — task priorities
    globals: dict               # sync results, keyed by SyncOp.key
    superstep: int
    n_updates: torch.Tensor     # 0-d int64 on the device: no sync per phase


def init_engine_state(vertex_data: dict, edge_data: dict, n_vertices: int,
                      syncs: Sequence[SyncOp], device) -> EngineState:
    """Every vertex scheduled, priorities 1, syncs evaluated once."""
    active = torch.ones(n_vertices, dtype=torch.bool, device=device)
    return EngineState(
        vertex_data=vertex_data, edge_data=edge_data, active=active,
        priority=active.to(torch.float32),
        globals={s.key: s.run(vertex_data) for s in syncs},
        superstep=0,
        n_updates=torch.zeros((), dtype=torch.int64, device=device))


def build_color_batches(colors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-color vertex-id lists into [n_colors, Cmax] (+valid mask)."""
    colors = np.asarray(colors)
    n_colors = int(colors.max()) + 1 if colors.size else 1
    groups = [np.nonzero(colors == c)[0] for c in range(n_colors)]
    cmax = max(1, max(len(g) for g in groups))
    ids = np.zeros((n_colors, cmax), dtype=np.int32)
    valid = np.zeros((n_colors, cmax), dtype=bool)
    for c, g in enumerate(groups):
        ids[c, : len(g)] = g
        valid[c, : len(g)] = True
    return ids, valid


# ----------------------------------------------------------------------
# Task-set algebra
# ----------------------------------------------------------------------

def consume_and_reschedule(active, priority, ids, sel, nbr_ids, nbr_mask,
                           res):
    """Consume executed tasks and merge the returned task set; returns
    new ``(active, priority)`` tensors.

    Every scatter takes only its selected entries (a boolean-mask
    compaction).  The reference instead routes unselected entries to an
    out-of-range sentinel row that ``mode="drop"`` discards; on the GPU
    that row is one address every masked-off entry writes, and at full
    size (1.26M x 256 slots per phase, nearly all masked off) the
    priority max-scatter serialized on it for 4.7 s of a 5.2 s
    superstep (PERF.md).  Rescheduling a neighbour is a boolean OR (a
    fill of True, which duplicate ids cannot make nondeterministic);
    priorities merge with ``scatter_reduce(..., "amax")``, which is
    order-independent.
    """
    done = ids[sel].long()
    active = active.index_fill(0, done, False)
    priority = priority.index_fill(0, done, 0.0)
    if res.resched_self is not None:
        active.index_fill_(0, ids[sel & res.resched_self].long(), True)
    if res.resched_nbrs is not None:
        nmask = nbr_mask & sel[:, None] & res.resched_nbrs
        rows, slots = nmask.nonzero(as_tuple=True)
        targets = nbr_ids[rows, slots].long()
        active.index_fill_(0, targets, True)
        if res.priority is not None:
            # neighbors inherit the scheduling priority of the rescheduler
            priority.scatter_reduce_(
                0, targets, res.priority[rows].to(priority.dtype), "amax")
    if res.priority is not None and res.resched_self is not None:
        again = sel & res.resched_self
        priority.scatter_reduce_(0, ids[again].long(),
                                 res.priority[again].to(priority.dtype), "amax")
    return active, priority


# ----------------------------------------------------------------------
# Update dispatch (dense scopes or the aggregator kernel path)
# ----------------------------------------------------------------------

def route_batch_to_buckets(ell, ids, sel, w, vals=None):
    """Route batch-row slot arrays onto their bucketed rows.

    ``w [B, max_deg]`` (pre-masked weights) — and optionally
    ``vals [B, max_deg, F]`` — become per-bucket ``[Nv_b, W_b(, F)]``
    buffers; rows outside the batch stay zero (and are gated off by the
    row mask anyway).  Each bucket takes only its own batch rows (a
    ``nonzero`` of the bucket's membership), so the cost is the rows
    routed, not ``B`` per bucket.
    """
    pos = torch.where(sel, ell.inv_perm[ids.long()], ell.total_rows)
    w_blocks, v_blocks = [], []
    for b in range(ell.n_buckets):
        s, e, wb = ell.starts[b], ell.starts[b + 1], ell.widths[b]
        hit = (sel & (pos >= s) & (pos < e)).nonzero().squeeze(1)
        loc = pos[hit].long() - s
        wbuf = w.new_zeros((e - s, wb), dtype=torch.float32)
        wbuf[loc] = w[hit, :wb].float()
        w_blocks.append(wbuf)
        if vals is not None:
            vbuf = vals.new_zeros((e - s, wb) + vals.shape[2:],
                                  dtype=torch.float32)
            vbuf[loc] = vals[hit, :wb].float()
            v_blocks.append(vbuf)
    return w_blocks, v_blocks


def _owner_rows(ell, y_rows, ids, sel):
    """Bucketed-order results -> ``[B, F]`` owner-row results (the
    inverse-permutation gather; the hub-split branch waits for A6)."""
    y = y_rows[ell.inv_perm[ids.long()].long()]
    return torch.where(sel[:, None], y, 0.0)


def bucketed_dense_fold(ell, ids, sel, w, vals):
    """Reduce a dense batch scope through the kernel's fold of every
    bucket (one launch for each 16 non-empty buckets), at exactly the kernel path's ``[Nv_b, W_b]``
    shapes and with the same row gate, so both arms run one
    accumulation."""
    row_masks = ell.bucket_slices(ell.row_activation(ids, sel))
    w_blocks, v_blocks = route_batch_to_buckets(ell, ids, sel, w, vals)
    y_rows = ell_fold_bucketed(w_blocks, v_blocks, row_masks=row_masks)
    return _owner_rows(ell, y_rows, ids, sel)


def dispatch_update(struct, update_fn: UpdateFn, vertex_data, edge_data,
                    ids, sel, globals_, *, use_kernel: bool):
    """Materialize scopes for ``ids`` and run the update function.

    An update that declares a ``NeighborAggregator`` skips the dense
    ``[B, D, F]`` neighbour-data gather when ``use_kernel``: a lite
    scope is materialized and the aggregation runs through
    ``ell_spmv_bucketed``, one kernel launch over every degree bucket,
    each on its own rows.  With ``use_kernel=False`` the dense scope is
    materialized and reduced through ``bucketed_dense_fold`` — the same
    kernel at the same shapes — so the two arms are bitwise equal.
    """
    agg = update_fn.aggregator
    if agg is None:
        scope = gather_scopes(struct, vertex_data, edge_data, ids, globals_)
        return scope, update_fn(scope)
    ell = struct.ell
    if not use_kernel:
        scope = gather_scopes(struct, vertex_data, edge_data, ids, globals_)
        w = torch.where(scope.nbr_mask, agg.weight(scope), 0.0).float()
        vals = agg.feature(scope.nbr_data).float()
        y = bucketed_dense_fold(ell, ids, sel, w, vals)
        return scope, agg.combine(scope, y)
    scope = gather_scopes(struct, vertex_data, edge_data, ids, globals_,
                          with_nbr_data=False)
    x = agg.feature(vertex_data).float().contiguous()
    w = torch.where(scope.nbr_mask, agg.weight(scope), 0.0).float()
    w_blocks, _ = route_batch_to_buckets(ell, ids, sel, w)
    row_masks = ell.bucket_slices(ell.row_activation(ids, sel))
    y_rows = ell_spmv_bucketed(ell.nbrs, w_blocks, x, row_masks=row_masks)
    return scope, agg.combine(scope, _owner_rows(ell, y_rows, ids, sel))


def apply_batch(struct, update_fn: UpdateFn, carry, ids, valid, globals_, *,
                use_kernel: bool = True):
    """Execute one conflict-free batch: the body every engine shares,
    with the bucket dispatch (the window-shaped ``"batch"`` dispatch
    waits for ROADMAP A4).

    ``carry`` is ``(vertex_data, edge_data, active, priority,
    n_updates)``; ``valid`` masks padded batch slots; tasks actually
    executed are ``valid & active[ids]``.
    """
    vdata, edata, active, priority, n_upd = carry
    sel = valid & active[ids.long()]
    scope, res = dispatch_update(
        struct, update_fn, vdata, edata, ids, sel, globals_,
        use_kernel=use_kernel)
    vdata, edata = scatter_result(struct, vdata, edata, ids, sel, scope, res)
    active, priority = consume_and_reschedule(
        active, priority, ids, sel, scope.nbr_ids, scope.nbr_mask, res)
    return vdata, edata, active, priority, n_upd + sel.sum()


# ----------------------------------------------------------------------
# Sync-op refresh
# ----------------------------------------------------------------------

def refresh_syncs(syncs: Sequence[SyncOp], globals_: dict, vertex_data,
                  superstep: int) -> dict:
    """Refresh every sync op whose tau divides the finished superstep."""
    new_globals = dict(globals_)
    for s in syncs:
        if (superstep + 1) % max(s.tau, 1) == 0:
            new_globals[s.key] = s.run(vertex_data)
    return new_globals


# ----------------------------------------------------------------------
# The executor: a host loop over strategy-selected batches
# ----------------------------------------------------------------------

@dataclasses.dataclass
class ExecutorCore:
    """Engine skeleton; subclasses supply the scheduling strategy via
    ``select(c) -> (ids [B], valid [B])`` for phase ``c``, and set
    ``n_phases``."""

    graph: DataGraph
    update_fn: UpdateFn
    syncs: Sequence[SyncOp] = ()
    max_supersteps: int = 100
    use_kernel: bool = True                 # aggregator kernel path on?
    n_phases: int = dataclasses.field(init=False, default=1)

    def select(self, c: int):
        """Phase ``c``'s conflict-free batch: (ids [B], valid [B])."""
        raise NotImplementedError

    def init_state(self) -> EngineState:
        return init_engine_state(
            self.graph.vertex_data, self.graph.edge_data,
            self.graph.n_vertices, self.syncs, self.graph.device)

    def _superstep(self, state: EngineState) -> EngineState:
        """One superstep: every phase in order, then the sync refresh."""
        carry = (state.vertex_data, state.edge_data, state.active,
                 state.priority, state.n_updates)
        for c in range(self.n_phases):
            ids, valid = self.select(c)
            carry = apply_batch(
                self.graph, self.update_fn, carry, ids, valid,
                state.globals, use_kernel=self.use_kernel)
        vdata, edata, active, priority, n_upd = carry
        return EngineState(
            vertex_data=vdata, edge_data=edata, active=active,
            priority=priority,
            globals=refresh_syncs(self.syncs, state.globals, vdata,
                                  state.superstep),
            superstep=state.superstep + 1, n_updates=n_upd)

    def run(self, num_supersteps: int | None = None) -> EngineState:
        """Run to convergence of the task set (or max/num supersteps)."""
        return self.resume(self.init_state(), num_supersteps)

    def resume(self, state: EngineState,
               num_supersteps: int | None = None) -> EngineState:
        """Continue from an existing EngineState: exactly
        ``num_supersteps`` steps, or until the task set drains or
        ``max_supersteps`` is reached."""
        if num_supersteps is not None:
            for _ in range(num_supersteps):
                state = self._superstep(state)
            return state
        while state.superstep < self.max_supersteps and bool(
                state.active.any()):
            state = self._superstep(state)
        return state
