"""Shared executor core: one engine skeleton, many scheduling strategies.

The port of ``repro.core.exec``:

* ``EngineState`` / ``init_engine_state`` — the engine state, a
  dataclass of tensors (``superstep`` is a host int: the host loop
  counts it);
* ``consume_and_reschedule`` — the task-set algebra, with FIFO
  insertion stamps.  Torch scatters have no ``mode="drop"``; each
  scatter takes only its selected entries (a boolean-mask compaction)
  instead of routing the others to an out-of-range row;
* ``scope_claims`` / ``self_claims`` / ``claim_winners`` /
  ``adjacent_claim_winners`` — the locking engine's claim pass: min-id
  lock acquisition as ``scatter_reduce_(..., "amin")`` on int32, which
  is order-free and so deterministic (claims by global id, for the
  distributed engine, wait for ROADMAP A9);
* ``choose_dispatch`` / ``switch_on_window_width`` — the launch shape
  of a phase: every bucket's rows (``"bucket"``), or the window alone at
  its snapped width ``[B, W]`` (``"batch"``), chosen on the host by one
  ``.item()`` a phase where the reference uses ``lax.switch``;
* ``dispatch_update`` — scope materialization and update dispatch:
  dense scopes, or the aggregator fast path through the ``ell_spmv``
  CUDA kernel (one launch over every degree bucket, or one ``[B, W]``
  launch over a window);
* ``apply_batch`` / ``refresh_syncs`` — one conflict-free batch end to
  end, and the periodic sync refresh;
* ``ExecutorCore`` — a host loop over supersteps that ends when the
  task set drains or ``max_supersteps`` is reached.  A concrete engine
  implements the scheduling strategy: ``prepare`` once a superstep,
  ``select`` for each phase, and optionally ``nbr_stamp``.

On a hub-split graph both dispatch shapes run stage 1 over virtual rows
(``[Nv_b, W_b]`` bucket blocks, or ``[B*s, w_cap]`` chunk pseudo-rows of
a window wider than ``w_cap``) and stage 2, the sum of each owner's
partials, through the ``segment_combine`` CUDA kernel
(``segment_sum_csr``), one combine shared by the kernel and dense arms.
The fitted cost model is not ported yet (ROADMAP A8).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.graph import DataGraph
from repro_torch.core.sync import SyncOp
from repro_torch.core.update import UpdateFn, gather_scopes, scatter_result
from repro_torch.kernels.ell_spmv import (ell_fold, ell_fold_bucketed,
                                          ell_spmv_batched,
                                          ell_spmv_bucketed)
from repro_torch.kernels.segment_combine import segment_sum_csr


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


def _task_tensor(x, n_vertices: int, device, dtype, name: str):
    """An ``[n_vertices]`` task-set tensor from an array or a tensor."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    t = t.to(device, dtype)
    if t.shape != (n_vertices,):
        raise ValueError(f"{name} must be [{n_vertices}], got "
                         f"{tuple(t.shape)}")
    return t


def init_engine_state(vertex_data: dict, edge_data: dict, n_vertices: int,
                      syncs: Sequence[SyncOp], device, active=None,
                      priority=None) -> EngineState:
    """The task set ``active`` (default: every vertex) with priorities
    ``priority`` (default: 1 where active), syncs evaluated once.
    ``active`` and ``priority`` may be numpy arrays or tensors."""
    if active is None:
        active = torch.ones(n_vertices, dtype=torch.bool, device=device)
    else:
        active = _task_tensor(active, n_vertices, device, torch.bool,
                              "active")
    if priority is None:
        priority = active.to(torch.float32)
    else:
        priority = _task_tensor(priority, n_vertices, device, torch.float32,
                                "priority")
    return EngineState(
        vertex_data=vertex_data, edge_data=edge_data, active=active,
        priority=priority,
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
                           res, nbr_stamp=None):
    """Consume executed tasks and merge the returned task set; returns
    new ``(active, priority)`` tensors.  ``nbr_stamp`` (a float) is the
    priority rescheduled neighbours get instead of the rescheduler's
    (FIFO insertion stamps).

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
        if nbr_stamp is not None:
            # FIFO: neighbours enter the queue stamped with insertion time
            priority.scatter_reduce_(
                0, targets, priority.new_full(targets.shape, nbr_stamp),
                "amax")
        elif res.priority is not None:
            # neighbors inherit the scheduling priority of the rescheduler
            priority.scatter_reduce_(
                0, targets, res.priority[rows].to(priority.dtype), "amax")
    if res.priority is not None and res.resched_self is not None:
        again = sel & res.resched_self
        priority.scatter_reduce_(0, ids[again].long(),
                                 res.priority[again].to(priority.dtype), "amax")
    return active, priority


def stable_top_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Ids of the ``k`` largest scores, ties by lower id: the first ``k``
    of a stable descending sort (``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise), int32."""
    return torch.sort(score, descending=True, stable=True).indices[:k].to(
        torch.int32)


# ----------------------------------------------------------------------
# Min-id scope claims: the locking engine's conflict-resolution pass
# ----------------------------------------------------------------------

NO_CLAIM = torch.iinfo(torch.int32).max   # "nobody claims this row"


def scope_claims(struct, ids, sel, rows=None):
    """Deterministic lock acquisition as one min-scatter: every selected
    candidate ``ids[p]`` claims its whole scope (itself and its
    neighbour slots) with its own id.  Returns ``claim [n_rows] int32``:
    the least id over the candidates whose scope holds the row,
    ``NO_CLAIM`` where unclaimed.  ``rows`` shares the candidates'
    gathered adjacency with the winner check.
    """
    cid = ids.to(torch.int32)
    claim = torch.full((struct.n_rows,), NO_CLAIM, dtype=torch.int32,
                       device=ids.device)
    claim.scatter_reduce_(0, ids[sel].long(), cid[sel], "amin")
    rows = struct.struct_rows(ids) if rows is None else rows
    r, j = (rows.nbr_mask & sel[:, None]).nonzero(as_tuple=True)
    claim.scatter_reduce_(0, rows.nbrs[r, j].long(), cid[r], "amin")
    return claim


def self_claims(struct, ids, sel):
    """Candidacy marks: each selected candidate claims its own row only,
    so ``claim[x] == NO_CLAIM`` reads "x is not pending" (the claim
    array of the edge-consistency rule)."""
    claim = torch.full((struct.n_rows,), NO_CLAIM, dtype=torch.int32,
                       device=ids.device)
    return claim.scatter_reduce_(0, ids[sel].long(),
                                 ids[sel].to(torch.int32), "amin")


def claim_winners(struct, ids, sel, claim, rows=None):
    """Full consistency: a candidate wins iff it holds the least claim on
    every row of its scope.  Winners have disjoint scopes, and the least
    candidate always wins (min-id order is the deadlock-free lock
    order of the paper's §4.2.2)."""
    cid = ids.to(torch.int32)
    own = claim[ids.long()] == cid
    rows = struct.struct_rows(ids) if rows is None else rows
    nb_ok = torch.where(rows.nbr_mask, claim[rows.nbrs.long()] == cid[:, None],
                        True).all(dim=-1)
    return sel & own & nb_ok


def adjacent_claim_winners(struct, ids, sel, claim, rows=None):
    """Edge/vertex consistency over a ``self_claims`` array: a candidate
    wins iff its id is below every pending neighbour's (read locks are
    compatible).  Winners form an independent set."""
    cid = ids.to(torch.int32)
    own = claim[ids.long()] == cid
    rows = struct.struct_rows(ids) if rows is None else rows
    nb_ok = torch.where(rows.nbr_mask, claim[rows.nbrs.long()] > cid[:, None],
                        True).all(dim=-1)
    return sel & own & nb_ok


# ----------------------------------------------------------------------
# Update dispatch (dense scopes or the aggregator kernel path)
# ----------------------------------------------------------------------

DISPATCH_MODES = ("auto", "bucket", "batch")


def validate_dispatch(mode: str) -> None:
    """Reject an unknown dispatch string when an engine is built."""
    if mode not in DISPATCH_MODES:
        raise ValueError(
            f"unknown dispatch mode {mode!r}: expected one of "
            f"{DISPATCH_MODES} (DESIGN.md §8)")


def choose_dispatch(mode: str, batch_size: int, max_deg: int,
                    sliced_slots: int, cost_model=None) -> str:
    """Resolve a dispatch mode to ``"bucket"`` or ``"batch"``.

    ``"bucket"`` launches every bucket's rows (``sliced_slots`` slots, the
    sweep engines' shape); ``"batch"`` gathers the window at its snapped
    width and launches once at ``[B, W]`` (the window engines' shape).
    ``"auto"`` is the reference's static rule: batch iff the window at
    the widest bucket width (callers pass ``ell.widths[-1]``) has fewer
    slots than the sweep.  Both shapes give bitwise-equal results.  A
    fitted ``cost_model`` is not ported (ROADMAP A8): only ``None`` is
    accepted.
    """
    if cost_model is not None:
        raise ValueError("cost_model= is not ported to repro_torch yet "
                         "(ROADMAP A8): dispatch='auto' uses the static "
                         "slot-count rule")
    if mode in ("bucket", "batch"):
        return mode
    validate_dispatch(mode)
    return "batch" if batch_size * max_deg < sliced_slots else "bucket"


def switch_on_window_width(ell, ids, sel, width_fn, operand):
    """Run ``width_fn(W)(operand)`` at the window's snapped width ``W``:
    the widest bucket a selected row lives in (``window_bucket``, one
    device-to-host read), or the only width of a one-bucket graph."""
    widths = ell.scope_widths
    b = 0 if len(widths) == 1 else ell.window_bucket(ids, sel)
    return width_fn(widths[b])(operand)


def route_batch_to_buckets(ell, ids, sel, w, vals=None):
    """Route batch-row slot arrays onto their bucketed rows.

    ``w [B, max_deg]`` (pre-masked weights) — and optionally
    ``vals [B, max_deg, F]`` — become per-bucket ``[Nv_b, W_b(, F)]``
    buffers; rows outside the batch stay zero (and are gated off by the
    row mask anyway).  Each bucket takes only its own batch rows (a
    ``nonzero`` of the bucket's membership), so the cost is the rows
    routed, not ``B`` per bucket.

    On a split graph the batch's owner-space slot arrays are first cut
    into ``[B * n_chunks_max, w_cap]`` chunk pseudo-rows (slot ``j`` of
    row ``i`` is slot ``j % w_cap`` of pseudo-row ``i * n_chunks_max +
    j // w_cap``), each routed to its owner's virtual row.
    """
    if ell.w_cap is not None:
        wc, s_max = ell.w_cap, ell.n_chunks_max
        idl = ids.long()
        first = ell.vrow_offset[idl].long()
        k = torch.arange(s_max, device=ids.device)
        ok = sel[:, None] & (k < (ell.vrow_offset[idl + 1].long()
                                  - first)[:, None])
        vid = (first[:, None] + k).clamp_max(ell.n_virtual - 1)
        pos = torch.where(ok, ell.inv_perm[vid], ell.total_rows).view(-1)
        t = s_max * wc
        w = _pad_slots(w, t).reshape(-1, wc)
        if vals is not None:
            vals = _pad_slots(vals, t).reshape((-1, wc) + vals.shape[2:])
        sel = ok.view(-1)
    else:
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


def _pad_slots(a, t):
    """``a [B, D, ...]`` cut or zero-padded to ``t`` slots (pre-masked:
    the slots past a row's width are zero)."""
    d = a.shape[1]
    if d >= t:
        return a[:, :t]
    out = a.new_zeros((a.shape[0], t) + a.shape[2:])
    out[:, :d] = a
    return out


def _owner_rows(ell, y_rows, ids, sel):
    """Bucketed-order results -> ``[B, F]`` owner-row results.

    Unsplit this is the inverse-permutation gather.  On a split graph
    the virtual-row partials, in virtual-row order, are summed onto
    their owners by ``segment_sum_csr`` over ``vrow_offset`` (an owner's
    virtual rows are contiguous): stage 2 of the hub split, the one op
    both arms exit through.
    """
    if ell.w_cap is None:
        y = y_rows[ell.inv_perm[ids.long()].long()]
    else:
        y_own = segment_sum_csr(y_rows[ell.inv_perm.long()],
                                ell.vrow_offset)
        y = y_own[ids.long()]
    return torch.where(sel[:, None], y, 0.0)


def _combine_chunks(y_part, b: int, n_chunk: int):
    """``[b * n_chunk, F]`` chunk partials -> ``[b, F]``: each window
    row's chunks summed in chunk order (``segment_sum_csr``)."""
    offsets = torch.arange(b + 1, dtype=torch.int64,
                           device=y_part.device) * n_chunk
    return segment_sum_csr(y_part, offsets)


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
                    ids, sel, globals_, *, use_kernel: bool, rows=None,
                    batch_shaped: bool = False):
    """Materialize scopes for ``ids`` and run the update function.

    An update that declares a ``NeighborAggregator`` skips the dense
    ``[B, D, F]`` neighbour-data gather when ``use_kernel``: a lite
    scope is materialized and the aggregation runs through
    ``ell_spmv_bucketed``, one kernel launch over every degree bucket,
    each on its own rows.  With ``use_kernel=False`` the dense scope is
    materialized and reduced through ``bucketed_dense_fold`` — the same
    kernel at the same shapes — so the two arms are bitwise equal.

    ``batch_shaped`` is the window dispatch: ``rows`` is the window's
    ``[B, W]`` adjacency at its snapped width, the kernel arm launches
    ``ell_spmv_batched`` once at ``[B, W]``, and the dense arm folds the
    same ``[B, W]`` scope through ``ell_fold``, one accumulation again.
    On a split graph a window wider than ``w_cap`` runs both at
    ``[B*s, w_cap]`` chunk pseudo-rows and sums each row's chunks with
    ``segment_sum_csr``.
    """
    agg = update_fn.aggregator
    if agg is None:
        scope = gather_scopes(struct, vertex_data, edge_data, ids, globals_,
                              rows=rows)
        return scope, update_fn(scope)
    # a window wider than w_cap (it holds a hub) runs as its chunks
    w_cap = struct.ell.w_cap
    win_w = rows.nbrs.shape[1] if batch_shaped else 0
    n_chunk = win_w // w_cap if w_cap is not None and win_w > w_cap else 1

    def chunked(a):
        return a.reshape((a.shape[0] * n_chunk, a.shape[1] // n_chunk)
                         + a.shape[2:]).contiguous()

    row_sel = sel.repeat_interleave(n_chunk) if n_chunk > 1 else sel
    if not use_kernel:
        scope = gather_scopes(struct, vertex_data, edge_data, ids, globals_,
                              rows=rows)
        w = torch.where(scope.nbr_mask, agg.weight(scope), 0.0).float()
        vals = agg.feature(scope.nbr_data).float()
        if not batch_shaped:
            y = bucketed_dense_fold(struct.ell, ids, sel, w, vals)
        else:
            y = ell_fold(chunked(w), chunked(vals), row_mask=row_sel)
            if n_chunk > 1:
                y = _combine_chunks(y, w.shape[0], n_chunk)
        return scope, agg.combine(scope, y)
    scope = gather_scopes(struct, vertex_data, edge_data, ids, globals_,
                          with_nbr_data=False, rows=rows)
    x = agg.feature(vertex_data).float().contiguous()
    w = torch.where(scope.nbr_mask, agg.weight(scope), 0.0).float()
    if batch_shaped:
        y = ell_spmv_batched(chunked(scope.nbr_ids), chunked(w), x,
                             row_mask=row_sel)
        if n_chunk > 1:
            y = _combine_chunks(y, w.shape[0], n_chunk)
        return scope, agg.combine(scope, y)
    ell = struct.ell
    w_blocks, _ = route_batch_to_buckets(ell, ids, sel, w)
    row_masks = ell.bucket_slices(ell.row_activation(ids, sel))
    y_rows = ell_spmv_bucketed(ell.nbrs, w_blocks, x, row_masks=row_masks)
    return scope, agg.combine(scope, _owner_rows(ell, y_rows, ids, sel))


def _apply_selected(struct, update_fn: UpdateFn, carry, ids, sel, globals_,
                    *, nbr_stamp, use_kernel: bool, rows,
                    batch_shaped: bool):
    """Gather/kernel -> update -> write-back -> bookkeeping for a resolved
    selection mask (the shared tail of both dispatch shapes)."""
    vdata, edata, active, priority, n_upd = carry
    scope, res = dispatch_update(
        struct, update_fn, vdata, edata, ids, sel, globals_,
        use_kernel=use_kernel, rows=rows, batch_shaped=batch_shaped)
    vdata, edata = scatter_result(struct, vdata, edata, ids, sel, scope, res)
    active, priority = consume_and_reschedule(
        active, priority, ids, sel, scope.nbr_ids, scope.nbr_mask, res,
        nbr_stamp=nbr_stamp)
    return vdata, edata, active, priority, n_upd + sel.sum()


def apply_batch(struct, update_fn: UpdateFn, carry, ids, valid, globals_, *,
                nbr_stamp=None, use_kernel: bool = True,
                dispatch: str = "bucket"):
    """Execute one conflict-free batch: the body every engine shares.

    ``carry`` is ``(vertex_data, edge_data, active, priority,
    n_updates)``; ``valid`` masks padded batch slots; tasks actually
    executed are ``valid & active[ids]``.  ``dispatch`` is the launch
    shape (resolve ``"auto"`` with ``choose_dispatch`` first):
    ``"bucket"`` gathers scopes at ``max_deg`` and launches every
    bucket's rows, ``"batch"`` runs the whole body at the window's
    snapped width ``[B, W]``.  Both give bitwise-equal results:
    trailing zero-weight slots add exactly +0.0.
    """
    vdata, edata, active, priority, n_upd = carry
    sel = valid & active[ids.long()]
    if dispatch == "batch":
        def at_width(w):
            def body(carry):
                return _apply_selected(
                    struct, update_fn, carry, ids, sel, globals_,
                    nbr_stamp=nbr_stamp, use_kernel=use_kernel,
                    rows=struct.struct_rows(ids, width=w),
                    batch_shaped=True)
            return body
        return switch_on_window_width(struct.ell, ids, sel, at_width, carry)
    return _apply_selected(
        struct, update_fn, carry, ids, sel, globals_, nbr_stamp=nbr_stamp,
        use_kernel=use_kernel, rows=None, batch_shaped=False)


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
    """Engine skeleton; subclasses supply the scheduling strategy.

    A strategy answers one question — which conflict-free batch runs in
    phase ``c``? — with ``prepare(state)`` (once a superstep, e.g. a
    top-k selection) and ``select(c, ctx) -> (ids [B], valid [B])`` (for
    each of ``n_phases`` phases); ``nbr_stamp(state)`` may override the
    priority of rescheduled neighbours (FIFO).  Task bookkeeping, sync
    refresh, termination and kernel dispatch are shared.
    """

    graph: DataGraph
    update_fn: UpdateFn
    syncs: Sequence[SyncOp] = ()
    max_supersteps: int = 100
    use_kernel: bool = True                 # aggregator kernel path on?
    # launch shape of a phase: "bucket" (every bucket's rows), "batch"
    # (the window at its snapped width) or "auto" (choose_dispatch's
    # static rule).  Sweep strategies (chromatic, BSP) pin "bucket";
    # the window strategies (priority, locking) keep "auto".
    dispatch: str = "auto"
    n_phases: int = dataclasses.field(init=False, default=1)

    def __post_init__(self):
        # subclasses with their own __post_init__ chain back via super()
        validate_dispatch(self.dispatch)

    def prepare(self, state: EngineState):
        """Once-per-superstep selection context (e.g. top-k ids)."""
        return None

    def select(self, c: int, ctx):
        """Phase ``c``'s conflict-free batch: (ids [B], valid [B])."""
        raise NotImplementedError

    def nbr_stamp(self, state: EngineState):
        """Priority override for rescheduled neighbours (FIFO stamps)."""
        return None

    def resolve_dispatch(self, batch_size: int) -> str:
        """This engine's ``choose_dispatch`` for a batch of
        ``batch_size`` rows."""
        ell = self.graph.ell
        return choose_dispatch(self.dispatch, batch_size, ell.widths[-1],
                               ell.padded_slots)

    def init_state(self, active=None, priority=None) -> EngineState:
        return init_engine_state(
            self.graph.vertex_data, self.graph.edge_data,
            self.graph.n_vertices, self.syncs, self.graph.device,
            active=active, priority=priority)

    def _superstep(self, state: EngineState) -> EngineState:
        """One superstep: every phase in order, then the sync refresh."""
        ctx = self.prepare(state)
        stamp = self.nbr_stamp(state)
        carry = (state.vertex_data, state.edge_data, state.active,
                 state.priority, state.n_updates)
        for c in range(self.n_phases):
            ids, valid = self.select(c, ctx)
            carry = apply_batch(
                self.graph, self.update_fn, carry, ids, valid,
                state.globals, nbr_stamp=stamp, use_kernel=self.use_kernel,
                dispatch=self.resolve_dispatch(ids.shape[0]))
        vdata, edata, active, priority, n_upd = carry
        return EngineState(
            vertex_data=vdata, edge_data=edata, active=active,
            priority=priority,
            globals=refresh_syncs(self.syncs, state.globals, vdata,
                                  state.superstep),
            superstep=state.superstep + 1, n_updates=n_upd)

    def run(self, active=None, priority=None,
            num_supersteps: int | None = None) -> EngineState:
        """Run from the task set ``active`` (default: every vertex) with
        priorities ``priority`` (default: 1 where active) to convergence
        of the task set, or for ``num_supersteps`` supersteps."""
        return self.resume(self.init_state(active, priority), num_supersteps)

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
