"""Update functions and scopes (paper §3.2), batched over PyTorch tensors.

The port of ``repro.core.update``.  The user writes the paper's scope
program over a leading batch axis ``B`` of non-adjacent vertices:

    def update(scope: ScopeBatch) -> UpdateResult: ...

Vertex and edge data are dicts of tensors.  Padded neighbour slots have
``nbr_mask == False``; user code masks with it.  Rescheduling is
``resched_self`` / ``resched_nbrs``, with an optional ``priority``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import torch

from repro_torch.kernels.ell_spmv import ell_fold


class Consistency(enum.Enum):
    """Paper §3.5 consistency models."""
    FULL = "full"        # exclusive R/W on whole scope  -> distance-2 coloring
    EDGE = "edge"        # R/W vertex+edges, R neighbors -> distance-1 coloring
    VERTEX = "vertex"    # R/W vertex only               -> single color
    UNSAFE = "unsafe"    # no guarantee (paper: "at their own risk")


@dataclasses.dataclass
class ScopeBatch:
    """The scopes S_v of a batch of vertices, materialized by gathers.

    The slot axis D is ``max_deg`` on the bucket dispatch path and the
    window's snapped bucket width ``W <= max_deg`` on the batch-shaped
    path; user update functions treat it as opaque (mask with
    ``nbr_mask``, reduce over the axis).
    """
    v_ids: torch.Tensor         # [B] int32 vertex ids
    v_data: dict                # [B, ...]      central vertex data (R/W)
    nbr_ids: torch.Tensor       # [B, D] int32
    nbr_mask: torch.Tensor      # [B, D] bool
    nbr_data: dict | None       # [B, D, ...]   adjacent vertex data
    edge_data: dict             # [B, D, ...]   adjacent edge data
    e_ids: torch.Tensor         # [B, D] int32  slot edge ids (pad -> pad row)
    is_src: torch.Tensor        # [B, D] bool
    degree: torch.Tensor        # [B] int32
    globals: dict               # latest sync-op results, keyed by SyncOp.key


@dataclasses.dataclass
class UpdateResult:
    v_data: dict                                # [B, ...] new central data
    edge_data: dict | None = None               # [B, D, ...] new edge data
    nbr_data: dict | None = None                # [B, D, ...] (FULL only)
    resched_self: torch.Tensor | None = None    # [B] bool
    resched_nbrs: torch.Tensor | None = None    # [B, D] bool
    priority: torch.Tensor | None = None        # [B] float32


@dataclasses.dataclass(frozen=True)
class NeighborAggregator:
    """Declares an update as a linear neighbour aggregation

        y[v] = sum_j  w[v, j] * feature(D_{nbr(v, j)})

    followed by per-vertex post-processing, so the executor can skip
    the dense ``[B, D, F]`` scope gather and run the sum through the
    ``ell_spmv`` kernel.

    * ``feature(vertex_data) -> [..., F]`` — a rowwise map;
    * ``weight(scope) -> [B, D]`` — per-slot weights from a lite scope
      (``nbr_data`` is None there);
    * ``combine(scope, y) -> UpdateResult`` — post-processing of
      ``y [B, F]``; must not touch ``scope.nbr_data``.
    """
    feature: Callable[[dict], torch.Tensor]
    weight: Callable[[ScopeBatch], torch.Tensor]
    combine: Callable[[ScopeBatch, torch.Tensor], UpdateResult]


@dataclasses.dataclass(frozen=True)
class UpdateFn:
    """An update function plus the consistency model it requires."""
    fn: Callable[[ScopeBatch], UpdateResult]
    consistency: Consistency = Consistency.EDGE
    name: str = "update"
    aggregator: NeighborAggregator | None = None

    def __call__(self, scope: ScopeBatch) -> UpdateResult:
        return self.fn(scope)


def weighted_slot_fold(w: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """sum_j w[:, j] * vals[:, j] — w [B, D] (pre-masked), vals [B, D, F],
    through the ``ell_spmv`` kernel's accumulation (``ell_fold``)."""
    return ell_fold(w.contiguous(), vals.contiguous())


def slot_fold_sum(vals: torch.Tensor) -> torch.Tensor:
    """acc += vals[:, j] for j in slot order: a left fold over the slot
    axis in float32.  Add-only, so it rounds the same wherever it runs
    and at any slot width (trailing zero slots add exactly +0.0)."""
    acc = vals.new_zeros(vals.shape[:1] + vals.shape[2:], dtype=torch.float32)
    for j in range(vals.shape[1]):
        acc = acc + vals[:, j]
    return acc


def masked_neighbor_sum(weights: torch.Tensor, values: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """sum_j mask * weights[:, j] * values[:, j] in float32 through the
    kernel's accumulation (``weighted_slot_fold``); values [B, D] or
    [B, D, F]."""
    w = torch.where(mask, weights, 0.0).float()
    squeeze = values.dim() == 2
    vals = (values[..., None] if squeeze else values).float()
    y = weighted_slot_fold(w, vals)
    return y[..., 0] if squeeze else y


def aggregator_update(feature, weight, combine,
                      consistency: Consistency = Consistency.EDGE,
                      name: str = "aggregate") -> UpdateFn:
    """Build an UpdateFn from a NeighborAggregator declaration.

    The dense ``fn`` (fully materialized scopes) derives from the same
    (feature, weight, combine) triple and reduces through the same
    kernel arithmetic.
    """
    agg = NeighborAggregator(feature=feature, weight=weight, combine=combine)

    def dense_fn(scope: ScopeBatch) -> UpdateResult:
        w = torch.where(scope.nbr_mask, weight(scope), 0.0).float()
        vals = feature(scope.nbr_data).float()
        return combine(scope, weighted_slot_fold(w, vals))

    return UpdateFn(dense_fn, consistency, name=name, aggregator=agg)


# ----------------------------------------------------------------------
# Scope materialization: the gather (pull) half of the engine.
# ----------------------------------------------------------------------

def gather_scopes(graph_struct, vertex_data: dict, edge_data: dict,
                  v_ids: torch.Tensor, globals_: dict,
                  with_nbr_data: bool = True, rows=None) -> ScopeBatch:
    """Materialize ScopeBatch for the vertex ids ``v_ids`` ([B] int32).

    ``graph_struct`` exposes ``struct_rows(ids)`` / ``degree``.
    ``with_nbr_data=False`` produces a lite scope (``nbr_data=None``)
    for the aggregator fast path, skipping the [B, D, F] gather.
    ``rows`` takes the batch's already-gathered adjacency (a claim
    pass's, or a window's at its snapped width), which also sets the
    scope's slot width.
    """
    if rows is None:
        rows = graph_struct.struct_rows(v_ids)
    vi = v_ids.long()
    eids = rows.edge_ids.long()
    nbr_data = None
    if with_nbr_data:
        nbrs = rows.nbrs.long()
        nbr_data = {k: a[nbrs] for k, a in vertex_data.items()}
    return ScopeBatch(
        v_ids=v_ids,
        v_data={k: a[vi] for k, a in vertex_data.items()},
        nbr_ids=rows.nbrs,
        nbr_mask=rows.nbr_mask,
        nbr_data=nbr_data,
        edge_data={k: a[eids] for k, a in edge_data.items()},
        e_ids=rows.edge_ids,
        is_src=rows.is_src,
        degree=graph_struct.degree[vi],
        globals=globals_,
    )


def _put_rows(dst: torch.Tensor, idx: torch.Tensor, new: torch.Tensor,
              keep: torch.Tensor) -> torch.Tensor:
    """A copy of ``dst`` with ``dst[idx[keep]] = new[keep]``: the
    reference's ``.at[idx].set(new, mode="drop")`` with unselected
    entries left out by compaction rather than sent to an out-of-range
    row (one address that every masked-off write would hit)."""
    out = dst.clone()
    out[idx[keep].long()] = new[keep].to(dst.dtype)
    return out


def scatter_result(graph_struct, vertex_data: dict, edge_data: dict,
                   v_ids: torch.Tensor, valid: torch.Tensor,
                   scope: ScopeBatch, result: UpdateResult):
    """Write back an UpdateResult (the push half).  ``valid`` masks
    padded batch rows; the engines guarantee batches are conflict-free
    for the declared consistency model, so plain scatters are exact.
    Returns new dicts; the inputs are not modified.  Masked-off edge
    writes are dropped (the reference parks them in the pad edge row,
    whose contents no update reads)."""
    vertex_data = dict(vertex_data)
    for k, new in result.v_data.items():
        vertex_data[k] = _put_rows(vertex_data[k], v_ids, new, valid)
    if result.edge_data is not None:
        emask = scope.nbr_mask & valid[:, None]
        edge_data = dict(edge_data)
        for k, new in result.edge_data.items():
            edge_data[k] = _put_rows(edge_data[k], scope.e_ids, new, emask)
    if result.nbr_data is not None:
        nmask = scope.nbr_mask & valid[:, None]
        for k, new in result.nbr_data.items():
            vertex_data[k] = _put_rows(vertex_data[k], scope.nbr_ids, new,
                                       nmask)
    return vertex_data, edge_data
