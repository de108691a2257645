"""The Chromatic Engine (paper §4.2.1) as a scheduling strategy.

All active vertices of color 0 update in parallel, then color 1, ...;
one sweep over all colors is a superstep.  No two same-colored vertices
are adjacent, so each color phase is conflict-free and the execution
equals the sequential one in (color, vertex-id) order.  Everything but
the choice of batch lives in ``repro_torch.core.exec``; this class
answers only "which batch runs in phase c?": the static per-color
vertex batches, each padded to the largest color class (the reference's
layout: every phase gathers ``[Cmax, max_deg]``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.exec import ExecutorCore, build_color_batches
from repro_torch.core.registry import register_scheduler


@dataclasses.dataclass
class ChromaticEngine(ExecutorCore):
    """Strategy: phase c = all active vertices of color c (static batches)."""

    # color batches sweep most of the graph: every bucket's rows is the
    # right launch shape (DESIGN.md §8)
    dispatch: str = "bucket"

    def __post_init__(self):
        super().__post_init__()
        if self.graph.colors is None:
            raise ValueError("graph needs colors; call graph.with_colors(...)")
        ids, valid = build_color_batches(self.graph.colors.cpu().numpy())
        dev = self.graph.device
        self._color_ids = torch.from_numpy(ids).to(dev)
        self._color_valid = torch.from_numpy(valid).to(dev)
        self.n_colors = ids.shape[0]
        self.n_phases = self.n_colors

    def select(self, c: int, ctx):
        return self._color_ids[c], self._color_valid[c]


register_scheduler(
    "chromatic", ChromaticEngine, needs_colors=True,
    description="static per-color sweeps (§4.2.1); sequentially "
                "consistent for the coloring's consistency model")
