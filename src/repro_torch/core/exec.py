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
  is order-free and so deterministic; ``claim_ids`` lets the
  distributed engine claim by global id;
* ``choose_dispatch`` / ``switch_on_window_width`` — the launch shape
  of a phase: every bucket's rows (``"bucket"``), or the window alone at
  its snapped width ``[B, W]`` (``"batch"``), priced by the static
  slot-count rule or a fitted cost model (``repro_torch.profile``); the
  width is chosen on the host by one ``.item()`` a phase where the
  reference uses ``lax.switch``;
* ``dispatch_update`` — scope materialization and update dispatch:
  dense scopes, or the aggregator fast path through the ``ell_spmv``
  CUDA kernel (one launch over every degree bucket, or one ``[B, W]``
  launch over a window);
* ``apply_batch`` / ``refresh_syncs`` — one conflict-free batch end to
  end, and the periodic sync refresh;
* ``ExecutorCore`` — a host loop over supersteps that ends when the
  task set drains or ``max_supersteps`` is reached.  A concrete engine
  implements the scheduling strategy: ``prepare`` once a superstep,
  ``select`` for each phase, and optionally ``nbr_stamp``;
  ``profile_probe`` reports the launch shape of a state's first phase
  for ``api.run(profile=True)``; ``step_on`` / ``probe_on`` step and
  probe against a mutated graph (the serving path), and
  ``dirty_scope_mask`` turns mutated vertices into its task set.

Inside a ``repro_torch.profile.tracing()`` context the executor records
spans at its layer boundaries (``repro_torch.profile.trace.span``; a
no-op otherwise): ``job`` (``resume`` and ``api.run``'s stepping loop),
``superstep``, ``phase`` (with its ``superstep`` and ``phase`` ids),
``select`` (``prepare`` / ``select``), ``gather`` (the scope gather,
the routing onto the degree buckets, the row activation and the owner
rows), ``kernel`` (each ``ell_spmv`` / ``ell_fold`` /
``segment_sum_csr`` call, attribute ``kernel``), ``update`` (the
aggregator's ``weight`` / ``feature`` / ``combine`` or the dense
``update_fn``), ``writeback`` (``scatter_result``), ``reschedule``
(``consume_and_reschedule``) and ``syncs`` (``refresh_syncs`` and the
drain test).  Its counters: ``slots.real`` (the degrees of the rows a
phase updates, summed on the device), ``slots.gathered`` (``B x D`` of
every scope gather), ``slots.routed`` (the stored slots of every
routing onto the buckets) and ``phases.fallback`` (the bucket phases
gathered at ``max_deg`` and routed, with no ``PhaseBlocks`` plan).

On a hub-split graph both dispatch shapes run stage 1 over virtual rows
(``[Nv_b, W_b]`` bucket blocks, or ``[B*s, w_cap]`` chunk pseudo-rows of
a window wider than ``w_cap``) and stage 2, the sum of each owner's
partials, through the ``segment_combine`` CUDA kernel
(``segment_sum_csr``), one combine shared by the kernel and dense arms.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.graph import DataGraph, EllRows
from repro_torch.core.sync import SyncOp
from repro_torch.core.update import (UpdateFn, UpdateResult, gather_scopes,
                                     scatter_result)
from repro_torch.kernels.ell_spmv import (ell_fold, ell_fold_bucketed,
                                          ell_spmv_batched,
                                          ell_spmv_bucketed)
from repro_torch.kernels.segment_combine import segment_sum_csr
from repro_torch.profile.trace import count, span, tracing_on


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


def engine_state_field_names() -> tuple[str, ...]:
    """The EngineState field set, in declaration order.  Snapshots
    (``train.checkpoint``, ``repro_torch.ft``) record it, so a restore
    against a build whose EngineState gained or lost a field fails by
    name instead of resuming with a defaulted field."""
    return tuple(f.name for f in dataclasses.fields(EngineState))


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
                           res, nbr_stamp=None, slot_rows=None):
    """Consume executed tasks and merge the returned task set; returns
    new ``(active, priority)`` tensors.  ``nbr_stamp`` (a float) is the
    priority rescheduled neighbours get instead of the rescheduler's
    (FIFO insertion stamps).  ``slot_rows`` takes the neighbour slots
    flat: ``nbr_ids``, ``nbr_mask`` and ``res.resched_nbrs`` are
    ``[S]``, slot ``s`` belonging to row ``slot_rows[s]`` (a planned
    phase, whose groups have different widths).

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
        if slot_rows is None:
            nmask = nbr_mask & sel[:, None] & res.resched_nbrs
            rows, slots = nmask.nonzero(as_tuple=True)
            targets = nbr_ids[rows, slots].long()
        else:
            nmask = nbr_mask & sel[slot_rows] & res.resched_nbrs
            (slots,) = nmask.nonzero(as_tuple=True)
            rows = slot_rows[slots]
            targets = nbr_ids[slots].long()
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


def dirty_scope_mask(graph: DataGraph, vertices) -> torch.Tensor:
    """1-hop dirty closure of a mutated vertex set: ``[Nv]`` bool.

    The serving engine's bridge from mutations to the task set
    (DESIGN.md §13): a mutation invalidates every update whose scope can
    read the changed datum, the vertex itself and its neighbours (§3.1).
    Seeding ``active=`` with this mask makes an incremental recompute a
    plain scheduler run.  Only real neighbour slots mark a vertex."""
    dev = graph.device
    ids = torch.as_tensor(np.asarray(vertices, np.int64).reshape(-1),
                          device=dev)
    mask = torch.zeros(graph.n_vertices, dtype=torch.bool, device=dev)
    if ids.numel() == 0:
        return mask
    mask = mask.index_fill(0, ids, True)
    rows = graph.struct_rows(ids.to(torch.int32))
    return mask.index_fill(0, rows.nbrs[rows.nbr_mask].long(), True)


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


def _claim_ids(ids, claim_ids):
    return ids.to(torch.int32) if claim_ids is None else claim_ids


def scope_claims(struct, ids, sel, claim_ids=None, rows=None):
    """Deterministic lock acquisition as one min-scatter: every selected
    candidate ``ids[p]`` claims its whole scope (itself and its
    neighbour slots) with its claim id (its row id, or ``claim_ids[p]``:
    the distributed engine claims by global id, so the winners do not
    depend on the partition).  Returns ``claim [n_rows] int32``: the
    least id over the candidates whose scope holds the row,
    ``NO_CLAIM`` where unclaimed.  ``rows`` shares the candidates'
    gathered adjacency with the winner check.
    """
    cid = _claim_ids(ids, claim_ids)
    claim = torch.full((struct.n_rows,), NO_CLAIM, dtype=torch.int32,
                       device=ids.device)
    claim.scatter_reduce_(0, ids[sel].long(), cid[sel], "amin")
    rows = struct.struct_rows(ids) if rows is None else rows
    r, j = (rows.nbr_mask & sel[:, None]).nonzero(as_tuple=True)
    claim.scatter_reduce_(0, rows.nbrs[r, j].long(), cid[r], "amin")
    return claim


def self_claims(struct, ids, sel, claim_ids=None):
    """Candidacy marks: each selected candidate claims its own row only,
    so ``claim[x] == NO_CLAIM`` reads "x is not pending" (the claim
    array of the edge-consistency rule)."""
    cid = _claim_ids(ids, claim_ids)
    claim = torch.full((struct.n_rows,), NO_CLAIM, dtype=torch.int32,
                       device=ids.device)
    return claim.scatter_reduce_(0, ids[sel].long(), cid[sel], "amin")


def claim_winners(struct, ids, sel, claim, claim_ids=None, rows=None):
    """Full consistency: a candidate wins iff it holds the least claim on
    every row of its scope.  Winners have disjoint scopes, and the least
    candidate always wins (min-id order is the deadlock-free lock
    order of the paper's §4.2.2)."""
    cid = _claim_ids(ids, claim_ids)
    own = claim[ids.long()] == cid
    rows = struct.struct_rows(ids) if rows is None else rows
    nb_ok = torch.where(rows.nbr_mask, claim[rows.nbrs.long()] == cid[:, None],
                        True).all(dim=-1)
    return sel & own & nb_ok


def adjacent_claim_winners(struct, ids, sel, claim, claim_ids=None,
                           rows=None):
    """Edge/vertex consistency over a ``self_claims`` array: a candidate
    wins iff its id is below every pending neighbour's (read locks are
    compatible).  Winners form an independent set."""
    cid = _claim_ids(ids, claim_ids)
    own = claim[ids.long()] == cid
    rows = struct.struct_rows(ids) if rows is None else rows
    nb_ok = torch.where(rows.nbr_mask, claim[rows.nbrs.long()] > cid[:, None],
                        True).all(dim=-1)
    return sel & own & nb_ok


# ----------------------------------------------------------------------
# Update dispatch (dense scopes or the aggregator kernel path)
# ----------------------------------------------------------------------

DISPATCH_MODES = ("auto", "bucket", "batch")


def validate_dispatch(mode: str | None) -> None:
    """Reject an unknown dispatch string when an engine is built
    (``None`` is the reference's other spelling of ``"auto"``)."""
    if mode not in (None,) + DISPATCH_MODES:
        raise ValueError(
            f"unknown dispatch mode {mode!r}: expected one of "
            f"{DISPATCH_MODES} (DESIGN.md §8)")


def choose_dispatch(mode: str | None, batch_size: int, max_deg: int,
                    sliced_slots: int, cost_model=None,
                    bucket_launches=None) -> str:
    """Resolve a dispatch mode to ``"bucket"`` or ``"batch"``.

    ``"bucket"`` launches every bucket's rows (``sliced_slots`` slots, the
    sweep engines' shape); ``"batch"`` gathers the window at its snapped
    width and launches once at ``[B, W]`` (the window engines' shape).
    ``"auto"`` (or ``None``) without a model is the reference's static
    rule: batch iff the window at the widest bucket width (callers pass
    ``ell.widths[-1]``) has fewer slots than the sweep.  With a fitted
    ``cost_model`` the same two candidates are priced in measured
    microseconds: one ``[B, widths[-1]]`` batch launch against the
    bucket path's launch sequence (``bucket_launches``).  Either side
    predicting ``None`` falls back to the static rule, so a run with no
    model, or an empty one, chooses as before.  Both shapes give
    bitwise-equal results: the choice moves time, never an answer.
    """
    if mode in ("bucket", "batch"):
        return mode
    # same legal-set error text as construction-time validation
    validate_dispatch(mode)
    if cost_model is not None:
        t_batch = cost_model.predict(max_deg, batch_size)
        t_bucket = (None if bucket_launches is None
                    else cost_model.predict_launches(bucket_launches))
        if t_batch is not None and t_bucket is not None:
            return "batch" if t_batch < t_bucket else "bucket"
    return "batch" if batch_size * max_deg < sliced_slots else "bucket"


def switch_on_window_width(ell, ids, sel, width_fn, operand):
    """Run ``width_fn(W)(operand)`` at the window's snapped width ``W``:
    the widest bucket a selected row lives in (``window_bucket``, one
    device-to-host read), or the only width of a one-bucket graph."""
    widths = ell.scope_widths
    with span("select"):
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
    if tracing_on():
        count("slots.routed", ell.padded_slots)
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
        with span("kernel", kernel="segment_sum_csr"):
            y_own = segment_sum_csr(y_rows[ell.inv_perm.long()],
                                    ell.vrow_offset)
        y = y_own[ids.long()]
    return torch.where(sel[:, None], y, 0.0)


def _combine_chunks(y_part, b: int, n_chunk: int):
    """``[b * n_chunk, F]`` chunk partials -> ``[b, F]``: each window
    row's chunks summed in chunk order (``segment_sum_csr``)."""
    offsets = torch.arange(b + 1, dtype=torch.int64,
                           device=y_part.device) * n_chunk
    with span("kernel", kernel="segment_sum_csr"):
        return segment_sum_csr(y_part, offsets)


def bucketed_dense_fold(ell, ids, sel, w, vals):
    """Reduce a dense batch scope through the kernel's fold of every
    bucket (one launch for each 16 non-empty buckets), at exactly the kernel path's ``[Nv_b, W_b]``
    shapes and with the same row gate, so both arms run one
    accumulation."""
    with span("gather"):
        row_masks = ell.bucket_slices(ell.row_activation(ids, sel))
        w_blocks, v_blocks = route_batch_to_buckets(ell, ids, sel, w, vals)
    with span("kernel", kernel="ell_fold_bucketed"):
        y_rows = ell_fold_bucketed(w_blocks, v_blocks, row_masks=row_masks)
    with span("gather"):
        return _owner_rows(ell, y_rows, ids, sel)


def _gather(struct, vertex_data, edge_data, ids, globals_, **kw):
    """``gather_scopes`` in a ``gather`` span, its ``B x D`` slots
    counted."""
    with span("gather"):
        scope = gather_scopes(struct, vertex_data, edge_data, ids,
                              globals_, **kw)
    count("slots.gathered", scope.nbr_ids.numel())
    return scope


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
        scope = _gather(struct, vertex_data, edge_data, ids, globals_,
                        rows=rows)
        with span("update"):
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
        scope = _gather(struct, vertex_data, edge_data, ids, globals_,
                        rows=rows)
        with span("update"):
            w = torch.where(scope.nbr_mask, agg.weight(scope), 0.0).float()
            vals = agg.feature(scope.nbr_data).float()
        if not batch_shaped:
            y = bucketed_dense_fold(struct.ell, ids, sel, w, vals)
        else:
            with span("kernel", kernel="ell_fold"):
                y = ell_fold(chunked(w), chunked(vals), row_mask=row_sel)
            if n_chunk > 1:
                y = _combine_chunks(y, w.shape[0], n_chunk)
        with span("update"):
            return scope, agg.combine(scope, y)
    scope = _gather(struct, vertex_data, edge_data, ids, globals_,
                    with_nbr_data=False, rows=rows)
    with span("update"):
        x = agg.feature(vertex_data).float().contiguous()
        w = torch.where(scope.nbr_mask, agg.weight(scope), 0.0).float()
    if batch_shaped:
        with span("kernel", kernel="ell_spmv_batched"):
            y = ell_spmv_batched(chunked(scope.nbr_ids), chunked(w), x,
                                 row_mask=row_sel)
        if n_chunk > 1:
            y = _combine_chunks(y, w.shape[0], n_chunk)
        with span("update"):
            return scope, agg.combine(scope, y)
    ell = struct.ell
    with span("gather"):
        w_blocks, _ = route_batch_to_buckets(ell, ids, sel, w)
        row_masks = ell.bucket_slices(ell.row_activation(ids, sel))
    with span("kernel", kernel="ell_spmv_bucketed"):
        y_rows = ell_spmv_bucketed(ell.nbrs, w_blocks, x, row_masks=row_masks)
    with span("gather"):
        y = _owner_rows(ell, y_rows, ids, sel)
    with span("update"):
        return scope, agg.combine(scope, y)


def _apply_selected(struct, update_fn: UpdateFn, carry, ids, sel, globals_,
                    *, nbr_stamp, use_kernel: bool, rows,
                    batch_shaped: bool):
    """Gather/kernel -> update -> write-back -> bookkeeping for a resolved
    selection mask (the shared tail of both dispatch shapes)."""
    vdata, edata, active, priority, n_upd = carry
    scope, res = dispatch_update(
        struct, update_fn, vdata, edata, ids, sel, globals_,
        use_kernel=use_kernel, rows=rows, batch_shaped=batch_shaped)
    with span("writeback"):
        vdata, edata = scatter_result(struct, vdata, edata, ids, sel, scope,
                                      res)
    with span("reschedule"):
        active, priority = consume_and_reschedule(
            active, priority, ids, sel, scope.nbr_ids, scope.nbr_mask, res,
            nbr_stamp=nbr_stamp)
        return vdata, edata, active, priority, n_upd + sel.sum()


class PhaseBlocks(NamedTuple):
    """A phase laid out in advance (a chromatic engine's color-major
    plan): its rows fall into groups of one stored width, group ``g``
    being rows ``offsets[g]:offsets[g + 1]`` of the phase's ``ids`` with
    adjacency ``rows[g]`` (``[n_g, W_g]`` blocks of the plan's store).
    ``slot_rows`` (int32) gives the row of every slot of the groups'
    blocks laid flat one after another."""
    rows: tuple[EllRows, ...]
    offsets: tuple[int, ...]
    slot_rows: torch.Tensor

    @staticmethod
    def of(rows, offsets, device) -> "PhaseBlocks":
        """The blocks ``rows`` starting at ``offsets``, with their
        ``slot_rows``."""
        slot_rows = [torch.arange(a, b, dtype=torch.int32, device=device)
                     .repeat_interleave(r.nbrs.shape[1])
                     for a, b, r in zip(offsets, offsets[1:], rows)]
        return PhaseBlocks(tuple(rows), tuple(offsets), torch.cat(
            slot_rows or [torch.zeros(0, dtype=torch.int32, device=device)]))


def _joined(scopes, results):
    """The groups' results as one over the phase's rows, their
    neighbour slots flat (``[S]``, group after group, as ``slot_rows``
    lays them): ``(result, nbr_ids, nbr_mask)``, the last two ``None``
    if nothing reschedules a neighbour."""
    def cat(ts, flat=False):
        if ts[0] is None:
            return None
        return torch.cat([t.reshape(-1) if flat else t for t in ts])
    res = UpdateResult(
        v_data={k: cat([r.v_data[k] for r in results])
                for k in results[0].v_data},
        resched_self=cat([r.resched_self for r in results]),
        resched_nbrs=cat([r.resched_nbrs for r in results], flat=True),
        priority=cat([r.priority for r in results]))
    if res.resched_nbrs is None:
        return res, None, None
    return (res, cat([sc.nbr_ids for sc in scopes], flat=True),
            cat([sc.nbr_mask for sc in scopes], flat=True))


def _apply_planned(struct, update_fn: UpdateFn, carry, ids, sel, globals_,
                   plan: PhaseBlocks, *, nbr_stamp, use_kernel: bool):
    """One phase over its ``PhaseBlocks``: every group's scope gathered
    from its own block at its stored width (no routing, no host sync),
    one reduction over all the groups' blocks (``ell_spmv_bucketed``, or
    ``ell_fold_bucketed`` in the dense arm) whose rows come back in
    ``ids`` order, each group's update, then one write-back and one
    reschedule of the whole phase (edge and neighbour data, where an
    update writes them, group by group).  Every row is reduced in slot
    order at its group's width, its bucket's or a joined group's wider
    one, whose trailing empty slots add +0.0 as the routed path's
    ``max_deg`` ones do, and the phase's tasks merge as one call over
    the routed batch merges them, so the two are bitwise equal."""
    vdata, edata, active, priority, n_upd = carry
    if not plan.rows:
        return carry
    cuts = list(zip(plan.offsets, plan.offsets[1:]))
    agg = update_fn.aggregator
    lite = agg is not None and use_kernel
    scopes = [_gather(struct, vdata, edata, ids[a:b], globals_,
                      with_nbr_data=not lite, rows=rows)
              for (a, b), rows in zip(cuts, plan.rows)]
    if agg is None:
        with span("update"):
            results = [update_fn(scope) for scope in scopes]
    else:
        masks = [sel[a:b] for a, b in cuts]
        with span("update"):
            w = [torch.where(sc.nbr_mask, agg.weight(sc), 0.0).float()
                 for sc in scopes]
            if lite:
                x = agg.feature(vdata).float().contiguous()
            else:
                vals = [agg.feature(sc.nbr_data).float() for sc in scopes]
        if lite:
            with span("kernel", kernel="ell_spmv_bucketed"):
                y = ell_spmv_bucketed([r.nbrs for r in plan.rows], w, x,
                                      row_masks=masks)
        else:
            with span("kernel", kernel="ell_fold_bucketed"):
                y = ell_fold_bucketed(w, vals, row_masks=masks)
        with span("update"):
            y = torch.where(sel[:, None], y, 0.0)
            results = [agg.combine(sc, y[a:b])
                       for sc, (a, b) in zip(scopes, cuts)]
    with span("update"):
        res, nbr_ids, nbr_mask = _joined(scopes, results)
    with span("writeback"):
        vdata, edata = scatter_result(struct, vdata, edata, ids, sel, None,
                                      UpdateResult(v_data=res.v_data))
        for (a, b), scope, r in zip(cuts, scopes, results):
            if r.edge_data is not None or r.nbr_data is not None:
                vdata, edata = scatter_result(
                    struct, vdata, edata, ids[a:b], sel[a:b], scope,
                    dataclasses.replace(r, v_data={}))
    with span("reschedule"):
        active, priority = consume_and_reschedule(
            active, priority, ids, sel, nbr_ids, nbr_mask, res,
            nbr_stamp=nbr_stamp, slot_rows=plan.slot_rows)
    return vdata, edata, active, priority, n_upd + sel.sum()


def apply_batch(struct, update_fn: UpdateFn, carry, ids, valid, globals_, *,
                nbr_stamp=None, use_kernel: bool = True, rows=None,
                dispatch: str = "bucket", plan: PhaseBlocks | None = None):
    """Execute one conflict-free batch: the body every engine shares.

    ``carry`` is ``(vertex_data, edge_data, active, priority,
    n_updates)``; ``valid`` masks padded batch slots; tasks actually
    executed are ``valid & active[ids]``.  ``rows`` shares the batch's
    adjacency, already gathered by a claim pass, with the bucket shape.
    ``dispatch`` is the launch shape (resolve ``"auto"`` with ``choose_dispatch`` first):
    ``"bucket"`` gathers scopes at ``max_deg`` and launches every
    bucket's rows, ``"batch"`` runs the whole body at the window's
    snapped width ``[B, W]``.  Both give bitwise-equal results:
    trailing zero-weight slots add exactly +0.0.  ``plan`` (bucket
    dispatch) is the batch laid out in advance, ``ids`` in its order:
    each group runs at its stored width (``_apply_planned``), bitwise
    the routed path.  A bucket phase without one counts as
    ``phases.fallback``.
    """
    vdata, edata, active, priority, n_upd = carry
    with span("select"):
        sel = valid & active[ids.long()]
    if tracing_on():
        count("slots.real", (struct.degree[ids.long()] * sel).sum())
    if plan is not None:
        return _apply_planned(
            struct, update_fn, carry, ids, sel, globals_, plan,
            nbr_stamp=nbr_stamp, use_kernel=use_kernel)
    if dispatch == "batch":
        def at_width(w):
            def body(carry):
                with span("gather"):
                    rows = struct.struct_rows(ids, width=w)
                return _apply_selected(
                    struct, update_fn, carry, ids, sel, globals_,
                    nbr_stamp=nbr_stamp, use_kernel=use_kernel,
                    rows=rows, batch_shaped=True)
            return body
        return switch_on_window_width(struct.ell, ids, sel, at_width, carry)
    count("phases.fallback")
    return _apply_selected(
        struct, update_fn, carry, ids, sel, globals_, nbr_stamp=nbr_stamp,
        use_kernel=use_kernel, rows=rows, batch_shaped=False)


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


def tasks_left(state: EngineState) -> bool:
    """The drain test: whether the task set holds a task (one
    device-to-host read)."""
    with span("syncs"):
        return bool(state.active.any())


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
    # (the window at its snapped width) or "auto" / None (choose_dispatch:
    # the static rule, or cost_model's prices).  Sweep strategies
    # (chromatic, BSP) pin "bucket"; the window strategies (priority,
    # locking) keep "auto".
    dispatch: str | None = "auto"
    # fitted launch-time model consulted by dispatch="auto" (a
    # repro_torch.profile.CostModel or anything with its predict
    # surface); None keeps the static slot-count rule.  It moves the
    # launch shape only, never a result.
    cost_model: Any = None
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
        ``batch_size`` rows, with its ``cost_model``."""
        ell = self.graph.ell
        return choose_dispatch(self.dispatch, batch_size, ell.widths[-1],
                               ell.padded_slots, cost_model=self.cost_model,
                               bucket_launches=ell.bucket_launches)

    def phase_batch(self, c: int, ctx):
        """Phase ``c``'s ``(ids, valid, plan)``: ``select``'s batch, and
        the ``PhaseBlocks`` a strategy laid it out in (``None``: the
        phase is gathered and routed as it runs)."""
        return (*self.select(c, ctx), None)

    def profile_probe(self, state: EngineState) -> dict:
        """Launch shape of ``state``'s first phase, for trace records.

        Runs the strategy's selection (never the update body) and
        reports what the step will launch: batch mode the window's rows
        and snapped scope width, bucket mode the per-bucket launch
        sequence.  ``prepare`` and ``select`` are pure functions of the
        state (the claim pass, top-k and FIFO stamps included), so
        probing changes nothing the step then does; it costs one extra
        selection (and, for a multi-width window, one ``.item()``).
        """
        ctx = self.prepare(state)
        ids, valid = self.select(0, ctx)
        batch = int(ids.shape[0])
        mode = self.resolve_dispatch(batch)
        rec = {"mode": mode, "phases": int(self.n_phases)}
        ell = self.graph.ell
        if mode == "batch":
            b = (ell.window_bucket(ids, valid & state.active[ids.long()])
                 if len(ell.scope_widths) > 1 else 0)
            rec["rows"] = batch
            rec["width"] = int(ell.scope_widths[b])
        else:
            rec["launches"] = list(ell.bucket_launches)
        return rec

    def init_state(self, active=None, priority=None) -> EngineState:
        return init_engine_state(
            self.graph.vertex_data, self.graph.edge_data,
            self.graph.n_vertices, self.syncs, self.graph.device,
            active=active, priority=priority)

    def _superstep(self, state: EngineState) -> EngineState:
        """One superstep: every phase in order, then the sync refresh."""
        step = state.superstep
        with span("superstep", superstep=step):
            with span("select"):
                ctx = self.prepare(state)
                stamp = self.nbr_stamp(state)
            carry = (state.vertex_data, state.edge_data, state.active,
                     state.priority, state.n_updates)
            for c in range(self.n_phases):
                with span("phase", superstep=step, phase=c):
                    with span("select"):
                        ids, valid, plan = self.phase_batch(c, ctx)
                    carry = apply_batch(
                        self.graph, self.update_fn, carry, ids, valid,
                        state.globals, nbr_stamp=stamp,
                        use_kernel=self.use_kernel,
                        dispatch=("bucket" if plan is not None else
                                  self.resolve_dispatch(ids.shape[0])),
                        plan=plan)
            vdata, edata, active, priority, n_upd = carry
            with span("syncs"):
                globals_ = refresh_syncs(self.syncs, state.globals, vdata,
                                         step)
        return EngineState(
            vertex_data=vdata, edge_data=edata, active=active,
            priority=priority, globals=globals_, superstep=step + 1,
            n_updates=n_upd)

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
        with span("job"):
            if num_supersteps is not None:
                for _ in range(num_supersteps):
                    state = self._superstep(state)
                return state
            while (state.superstep < self.max_supersteps
                   and tasks_left(state)):
                state = self._superstep(state)
            return state

    # -- stepping against a mutated graph (the serving path) -----------
    def step_on(self, graph: DataGraph, state: EngineState) -> EngineState:
        """One superstep against ``graph``'s current structure (same
        vertex set and strategy constants as the build graph): the
        engine's graph takes ``graph``'s adjacency and degrees for the
        step, then its own back.  The reference traces the structure as
        an argument so slack inserts never recompile; eager torch has no
        compile to save, so the swap is all it needs."""
        base = self.graph
        self.graph = dataclasses.replace(base, ell=graph.ell,
                                         degree=graph.degree)
        try:
            return self._superstep(state)
        finally:
            self.graph = base

    def probe_on(self, graph: DataGraph, state: EngineState) -> dict:
        """``profile_probe`` against ``graph``'s current structure."""
        base = self.graph
        self.graph = graph
        try:
            return self.profile_probe(state)
        finally:
            self.graph = base
