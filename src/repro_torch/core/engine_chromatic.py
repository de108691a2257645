"""The Chromatic Engine (paper §4.2.1) as a scheduling strategy.

All active vertices of color 0 update in parallel, then color 1, ...;
one sweep over all colors is a superstep.  No two same-colored vertices
are adjacent, so each color phase is conflict-free and the execution
equals the sequential one in (color, vertex-id) order.  Everything but
the choice of batch lives in ``repro_torch.core.exec``; this class
answers only "which batch runs in phase c?": the static per-color
vertex batches, each padded to the largest color class (the reference's
layout: every phase gathers ``[Cmax, max_deg]``).

On unsplit storage with the bucket dispatch the engine lays the phases
out in a color-major plan (``ColorPlan``): a second sliced store of the
same rows whose blocks are the non-empty (color, stored width) groups
(``SlicedEll.regrouped``).  A phase then gathers and reduces only its
own rows, each at the width its bucket has in the graph's storage,
bitwise the padded phase's results.  A group whose rows pad the next
wider group of its color by at most ``graph.JOIN_PAD_SHARE`` of that
block joins it (a grid's few border rows).  The plan is laid out again
when the engine steps on another structure (``step_on`` after an
insert).  A hub-split graph (its owner combine) keeps the padded,
routed phases.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.exec import (ExecutorCore, PhaseBlocks,
                                   build_color_batches)
from repro_torch.core.graph import DataGraph, SlicedEll
from repro_torch.core.registry import register_scheduler


@dataclasses.dataclass
class ColorPlan:
    """The color-major phase plan of one unsplit ``SlicedEll``
    (``source``): ``store`` holds every row again, grouped by (color,
    bucket) in color-major order, each group one block at its bucket's
    width (or a wider group's it joined); phase ``c`` is
    ``phases[c] = (ids, valid, PhaseBlocks)``."""

    source: SlicedEll
    store: SlicedEll
    phases: tuple

    @staticmethod
    def build(graph: DataGraph, n_colors: int) -> "ColorPlan":
        """Lay ``graph``'s rows out by (color, bucket)."""
        store, groups = graph.ell.regrouped(graph.colors, n_colors)
        dev = store.device
        phases = tuple(
            (ids, torch.ones(ids.shape, dtype=torch.bool, device=dev),
             PhaseBlocks.of(rows, offsets, dev))
            for ids, rows, offsets in groups)
        return ColorPlan(source=graph.ell, store=store, phases=phases)


@dataclasses.dataclass
class ChromaticEngine(ExecutorCore):
    """Strategy: phase c = all active vertices of color c (static batches)."""

    # color batches sweep most of the graph: every bucket's rows is the
    # right launch shape (DESIGN.md §8)
    dispatch: str = "bucket"
    # the color-major phase plan (None: every phase padded and routed)
    plan: ColorPlan | None = dataclasses.field(init=False, default=None,
                                               repr=False)

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
        if (not self.graph.ell.is_split
                and self.resolve_dispatch(ids.shape[1]) == "bucket"):
            self.plan = ColorPlan.build(self.graph, self.n_colors)

    def select(self, c: int, ctx):
        return self._color_ids[c], self._color_valid[c]

    def phase_batch(self, c: int, ctx):
        """The plan's phase ``c``, laid out again first if the step runs
        on another structure than the plan's; without a plan
        ``select``'s padded batch."""
        if self.plan is None:
            return super().phase_batch(c, ctx)
        if self.graph.ell is not self.plan.source:
            self.plan = ColorPlan.build(self.graph, self.n_colors)
        return self.plan.phases[c]


register_scheduler(
    "chromatic", ChromaticEngine, needs_colors=True,
    description="static per-color sweeps (§4.2.1); sequentially "
                "consistent for the coloring's consistency model")
