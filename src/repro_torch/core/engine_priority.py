"""Priority engine: prioritized scheduling over a colorable graph (the
port of ``repro.core.engine_priority``).

Each superstep selects the ``k_select`` highest-priority active vertices
(ties by lower id, as ``jax.lax.top_k``: ``stable_top_k``) and executes
them color by color; same-colored vertices are non-adjacent, so each
phase is conflict-free.  Tasks therefore run in priority order with ties
broken by (color, id), a legal RemoveNext (paper §3.4).  ``fifo=True``
orders by insertion instead: rescheduled neighbours are stamped with the
superstep that inserted them, and earlier stamps run first.  The real
lock pipeline, which needs no coloring, is ``engine_locking``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.exec import EngineState, ExecutorCore, stable_top_k
from repro_torch.core.registry import register_scheduler


@dataclasses.dataclass
class PriorityEngine(ExecutorCore):
    """Strategy: top-k priority selection, executed color by color."""

    max_supersteps: int = 1000
    k_select: int = 64          # tasks in flight a superstep
    fifo: bool = False          # insertion order instead of priority

    def __post_init__(self):
        super().__post_init__()
        if self.graph.colors is None:
            raise ValueError("graph needs colors; call graph.with_colors(...)")
        self.n_colors = int(self.graph.colors.max()) + 1
        self.n_phases = self.n_colors

    def prepare(self, state: EngineState):
        k = min(self.k_select, self.graph.n_vertices)
        prio = -state.priority if self.fifo else state.priority
        score = torch.where(state.active, prio, -torch.inf)
        top_ids = stable_top_k(score, k)                 # [K]
        top_sel = state.active[top_ids.long()]           # drop -inf rows
        return top_ids, top_sel, self.graph.colors[top_ids.long()]

    def select(self, c: int, ctx):
        top_ids, top_sel, vcolors = ctx
        return top_ids, top_sel & (vcolors == c)

    def nbr_stamp(self, state: EngineState):
        return float(state.superstep + 1) if self.fifo else None


register_scheduler(
    "priority", PriorityEngine, extras=("k_select", "fifo"),
    needs_colors=True,
    description="top-k priority window executed color by color — the "
                "analogue of the paper's prioritized scheduling")
