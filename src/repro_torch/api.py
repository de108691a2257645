"""One paper-shaped entry point: data graph + update + sync -> run.

The port of ``repro.api.run`` for what is ported so far:

    from repro_torch import api
    from repro_torch.apps import pagerank

    graph, update, syncs = pagerank.build(edges, n)
    result = api.run(graph, update, syncs=syncs, scheduler="priority",
                     k_select=64)

Schedulers: ``chromatic``, ``bsp``, ``priority`` (``k_select``,
``fifo``) and ``locking`` (``max_pending``).  Any other scheduler or
option raises ``ValueError`` naming what is not ported yet;
``ROADMAP.md`` queue A says when it will be.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.core.exec import EngineState, validate_dispatch
from repro_torch.core.registry import (SHARED_KWARGS, get_scheduler,
                                       list_schedulers)
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


# options of the reference's run that the port does not take yet, and
# the ROADMAP item each waits for
_NOT_PORTED = {
    "until": "A7", "trace": "A7", "profile": "A8", "cost_model": "A8",
    "consistency": "A7", "n_shards": "A9", "partition": "A9",
    "exchange_edges": "A9", "checkpoint_every": "A10",
    "checkpoint_dir": "A10", "resume_from": "A10", "faults": "A10",
    "max_restarts": "A10", "slack": "A11", "edge_capacity": "A11",
    "publish_every": "A11",
}


def run(graph, update: UpdateFn, *, scheduler: str = "chromatic",
        syncs: Sequence[SyncOp] = (), max_supersteps: int | None = None,
        num_supersteps: int | None = None, use_kernel: bool = True,
        dispatch: str = "auto", active=None, priority=None,
        device=None, **options) -> RunResult:
    """Run ``update`` over ``graph`` under the named scheduler.

    Termination is the earliest of the task set draining,
    ``max_supersteps`` (the engine's default: 100 for chromatic and BSP,
    1000 for priority, 2000 for locking) or an explicit
    ``num_supersteps`` budget.  ``active`` / ``priority`` seed the task
    set and its priorities (default: every vertex at priority 1).
    ``dispatch`` picks the launch shape: ``"auto"`` keeps the
    scheduler's own (``"bucket"`` for the sweep engines, the static
    rule for the window engines), ``"bucket"`` / ``"batch"`` force one;
    results are bitwise the same.  ``use_kernel=False`` runs the
    aggregator's dense fallback (bitwise equal to the kernel path).
    Per-scheduler options (``k_select``, ``fifo``, ``max_pending``) are
    checked against the registry.  The run happens on ``device``
    (default: the GPU; see ``resolve_device``), and the graph is moved
    there if it lives elsewhere.
    """
    entry = get_scheduler(scheduler)
    waiting = sorted(k for k in options if k in _NOT_PORTED)
    if waiting:
        raise ValueError(
            f"{waiting} are not ported to repro_torch yet (ROADMAP "
            f"{', '.join(sorted({_NOT_PORTED[k] for k in waiting}))})")
    unknown = sorted(set(options) - set(entry.extras))
    if unknown:
        raise ValueError(
            f"{unknown} are not options of scheduler {scheduler!r}; it "
            f"takes {sorted(entry.extras)} besides syncs, "
            f"{', '.join(SHARED_KWARGS)}, num_supersteps, active, "
            "priority and device")
    if not isinstance(update, UpdateFn):
        raise ValueError(
            f"update must be an UpdateFn, got {type(update).__name__}")
    for key, v in (("max_supersteps", max_supersteps),
                   ("num_supersteps", num_supersteps)):
        if v is not None and (isinstance(v, bool) or not isinstance(v, int)
                              or v < (1 if key == "max_supersteps" else 0)):
            raise ValueError(f"{key} must be a positive int, got {v!r}")
    validate_dispatch(dispatch)
    device = resolve_device(device)
    if graph.device != device:
        graph = graph.to(device)
    if entry.needs_colors and graph.colors is None:
        raise ValueError(f"scheduler {scheduler!r} needs a colored graph; "
                         "call graph.with_colors(...)")
    kwargs = {"use_kernel": use_kernel, **options}
    if max_supersteps is not None:
        kwargs["max_supersteps"] = max_supersteps
    if dispatch != "auto":
        kwargs["dispatch"] = dispatch
    engine = entry.factory(graph, update, syncs=tuple(syncs), **kwargs)
    state = engine.run(active=active, priority=priority,
                       num_supersteps=num_supersteps)
    return RunResult(
        vertex_data=state.vertex_data, edge_data=state.edge_data,
        globals=state.globals, superstep=state.superstep,
        n_updates=int(state.n_updates),
        active_any=bool(state.active.any()), state=state, engine=engine)
