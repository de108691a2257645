"""The locking engine (paper §4.2.2), single-device part: a port of
``repro.core.engine_locking``'s ``conflict_winners``,
``conflict_winners_windowed`` and ``LockingEngine``.

Each superstep puts the ``max_pending`` highest-priority active vertices
in flight (the paper's lock pipeline), and a claim pass grants locks in
canonical min-id order: under FULL consistency a candidate claims its
whole scope (``scope_claims``) and wins iff it holds every claim;
under EDGE it claims its own row (``self_claims``) and wins iff no
pending neighbour has a smaller id; VERTEX and UNSAFE scopes never
conflict.  Winners run as one conflict-free batch, losers stay active
for the next superstep.  No coloring is needed.  The distributed engine
waits for ROADMAP A9.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.exec import (ExecutorCore, adjacent_claim_winners,
                                   claim_winners, scope_claims, self_claims,
                                   stable_top_k, switch_on_window_width)
from repro_torch.core.registry import register_scheduler
from repro_torch.core.update import Consistency


def conflict_winners(struct, ids, sel, consistency: Consistency,
                     rows=None):
    """Reader/writer lock grant as one claim scatter and one check, with
    the candidates' adjacency gathered once (``rows``, default
    ``[P, max_deg]``) for both."""
    if consistency == Consistency.FULL:
        rows = struct.struct_rows(ids) if rows is None else rows
        claim = scope_claims(struct, ids, sel, rows=rows)
        return claim_winners(struct, ids, sel, claim, rows=rows)
    if consistency == Consistency.EDGE:
        rows = struct.struct_rows(ids) if rows is None else rows
        claim = self_claims(struct, ids, sel)
        return adjacent_claim_winners(struct, ids, sel, claim, rows=rows)
    return sel      # VERTEX / UNSAFE: no inter-vertex conflicts


def conflict_winners_windowed(struct, ids, sel, consistency: Consistency):
    """``conflict_winners`` with the candidates' adjacency gathered at
    the pending window's snapped width ``[P, W]`` instead of
    ``[P, max_deg]``: the same winners."""
    if consistency not in (Consistency.FULL, Consistency.EDGE):
        return sel

    def at_width(w):
        def f(_):
            return conflict_winners(struct, ids, sel, consistency,
                                    rows=struct.struct_rows(ids, width=w))
        return f
    return switch_on_window_width(struct.ell, ids, sel, at_width, None)


@dataclasses.dataclass
class LockingEngine(ExecutorCore):
    """Strategy: a top-``max_pending`` pending window, min-id claim
    winners.  ``max_pending`` is the lock-pipeline depth of the paper's
    Fig. 8(b): 1 is strictly sequential, more admits more concurrent
    winners a superstep."""

    max_supersteps: int = 2000
    max_pending: int = 64       # P: in-flight scope acquisitions

    def __post_init__(self):
        super().__post_init__()
        self.n_phases = 1

    def prepare(self, state):
        p = min(self.max_pending, self.graph.n_vertices)
        score = torch.where(state.active, state.priority, -torch.inf)
        cand = stable_top_k(score, p)                    # [P] pending window
        cand_sel = state.active[cand.long()]
        consistency = self.update_fn.consistency
        if self.resolve_dispatch(p) == "batch":
            win = conflict_winners_windowed(self.graph, cand, cand_sel,
                                            consistency)
        else:
            win = conflict_winners(self.graph, cand, cand_sel, consistency)
        return cand, win

    def select(self, c: int, ctx):
        return ctx


register_scheduler(
    "locking", LockingEngine, extras=("max_pending",),
    description="pipelined reader/writer lock engine (§4.2.2): "
                "max_pending window + min-id claim winners; needs no "
                "coloring")
