"""String-keyed engine registry: scheduler names -> execution strategies.

The port of the single-device half of ``repro.core.registry``: engine
modules self-register here at import, and ``repro_torch.api`` resolves a
scheduler name through it.  Only ``chromatic`` is ported so far.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class SchedulerEntry:
    """One registered scheduling strategy: ``factory(graph, update_fn,
    syncs=..., max_supersteps=..., use_kernel=...)`` builds an
    ``ExecutorCore``."""
    name: str
    factory: Callable[..., Any]
    needs_colors: bool = False


_SCHEDULERS: dict[str, SchedulerEntry] = {}


def register_scheduler(name: str, factory: Callable[..., Any], *,
                       needs_colors: bool = False) -> SchedulerEntry:
    """Register a strategy; registering the same factory again is a
    no-op, a different factory under a taken name is an error."""
    prior = _SCHEDULERS.get(name)
    if prior is not None:
        if prior.factory is factory:
            return prior
        raise ValueError(f"scheduler name {name!r} is already registered "
                         f"to {prior.factory!r}")
    entry = SchedulerEntry(name=name, factory=factory,
                           needs_colors=needs_colors)
    _SCHEDULERS[name] = entry
    return entry


def _load_builtin() -> None:
    # the engine modules register themselves on import
    import repro_torch.core.engine_chromatic  # noqa: F401


def get_scheduler(name: str) -> SchedulerEntry:
    _load_builtin()
    entry = _SCHEDULERS.get(name)
    if entry is None:
        raise ValueError(
            f"scheduler {name!r} is not ported to repro_torch yet "
            f"(ROADMAP A4); ported: {list_schedulers()}")
    return entry


def list_schedulers() -> list[str]:
    _load_builtin()
    return sorted(_SCHEDULERS)
