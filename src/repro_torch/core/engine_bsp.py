"""BSP / Jacobi baseline engine — the "Pregel/Hadoop-style" comparison.

All active vertices update at once from the previous superstep's data
(bulk-synchronous, not sequentially consistent).  It is the chromatic
engine over the trivial single coloring: with one phase, every update
reads pre-step data.  The port of ``repro.core.engine_bsp``.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.coloring import single_color
from repro_torch.core.engine_chromatic import ChromaticEngine
from repro_torch.core.graph import DataGraph
from repro_torch.core.registry import register_scheduler
from repro_torch.core.sync import SyncOp
from repro_torch.core.update import UpdateFn


def bsp_engine(graph: DataGraph, update_fn: UpdateFn,
               syncs: Sequence[SyncOp] = (), max_supersteps: int = 100,
               use_kernel: bool = True, dispatch: str = "bucket",
               cost_model=None) -> ChromaticEngine:
    """Strategy: one phase holding every active vertex (trivial color).
    The phase batches the whole graph, so every bucket's rows is the
    natural launch shape."""
    g = graph.with_colors(single_color(graph.n_vertices))
    return ChromaticEngine(g, update_fn, syncs, max_supersteps,
                           use_kernel=use_kernel, dispatch=dispatch,
                           cost_model=cost_model)


register_scheduler(
    "bsp", bsp_engine,
    description="bulk-synchronous Jacobi sweeps (single trivial color); "
                "NOT sequentially consistent — the Fig. 1 baseline")
