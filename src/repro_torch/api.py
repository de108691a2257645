"""One paper-shaped entry point: data graph + update + sync -> run.

The port of ``repro.api.run`` for what is ported so far:

    from repro_torch import api
    from repro_torch.apps import pagerank

    graph, update, syncs = pagerank.build(edges, n)
    result = api.run(graph, update, syncs=syncs, scheduler="chromatic")

Any other scheduler or option raises ``ValueError`` naming what is not
ported yet; ``ROADMAP.md`` queue A says when it will be.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.core.exec import EngineState
from repro_torch.core.registry import get_scheduler, list_schedulers
from repro_torch.core.sync import SyncOp
from repro_torch.core.update import UpdateFn
from repro_torch.device import resolve_device

__all__ = ["RunResult", "run", "list_schedulers"]


@dataclasses.dataclass
class RunResult:
    """What ``run`` returns: the final vertex/edge data and sync globals,
    the superstep and update counts, whether tasks were left
    (``active_any``), and the final ``EngineState`` and engine."""
    vertex_data: dict
    edge_data: dict | None
    globals: dict
    superstep: int
    n_updates: int
    active_any: bool
    state: EngineState | None = None
    engine: Any = None


def run(graph, update: UpdateFn, *, scheduler: str = "chromatic",
        syncs: Sequence[SyncOp] = (), max_supersteps: int | None = None,
        num_supersteps: int | None = None, use_kernel: bool = True,
        device=None, **options) -> RunResult:
    """Run ``update`` over ``graph`` under the named scheduler.

    Termination is the earliest of the task set draining,
    ``max_supersteps`` (default 100) or an explicit ``num_supersteps``
    budget.  ``use_kernel=False`` runs the aggregator's dense fallback
    (bitwise equal to the kernel path).  The run happens on ``device``
    (default: the GPU; see ``resolve_device``), and the graph is moved
    there if it lives elsewhere.
    """
    if options:
        raise ValueError(
            f"{sorted(options)} are not ported to repro_torch yet (ROADMAP "
            "A4-A12); run accepts scheduler, syncs, max_supersteps, "
            "num_supersteps, use_kernel and device")
    entry = get_scheduler(scheduler)
    if not isinstance(update, UpdateFn):
        raise ValueError(
            f"update must be an UpdateFn, got {type(update).__name__}")
    for key, v in (("max_supersteps", max_supersteps),
                   ("num_supersteps", num_supersteps)):
        if v is not None and (isinstance(v, bool) or not isinstance(v, int)
                              or v < (1 if key == "max_supersteps" else 0)):
            raise ValueError(f"{key} must be a positive int, got {v!r}")
    device = resolve_device(device)
    if graph.device != device:
        graph = graph.to(device)
    if entry.needs_colors and graph.colors is None:
        raise ValueError(f"scheduler {scheduler!r} needs a colored graph; "
                         "call graph.with_colors(...)")
    kwargs = {"use_kernel": use_kernel}
    if max_supersteps is not None:
        kwargs["max_supersteps"] = max_supersteps
    engine = entry.factory(graph, update, syncs=tuple(syncs), **kwargs)
    state = engine.run(num_supersteps=num_supersteps)
    return RunResult(
        vertex_data=state.vertex_data, edge_data=state.edge_data,
        globals=state.globals, superstep=state.superstep,
        n_updates=int(state.n_updates),
        active_any=bool(state.active.any()), state=state, engine=engine)
