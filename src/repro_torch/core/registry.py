"""String-keyed engine registry: scheduler names -> execution strategies.

The port of the single-device half of ``repro.core.registry``: engine
modules self-register here at import, declaring the keyword arguments
they accept beyond the shared set (``extras``: ``k_select`` and
``fifo`` for priority, ``max_pending`` for locking), and
``repro_torch.api`` resolves a scheduler name through it.  Registered:
``chromatic``, ``bsp``, ``priority``, ``locking``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

# keyword arguments every registered strategy's factory understands
SHARED_KWARGS = ("max_supersteps", "use_kernel", "dispatch")


@dataclasses.dataclass(frozen=True)
class SchedulerEntry:
    """One registered scheduling strategy: ``factory(graph, update_fn,
    syncs=..., **kwargs)`` builds an ``ExecutorCore``; ``SHARED_KWARGS +
    extras`` is the keyword surface ``api.run`` accepts for it."""
    name: str
    factory: Callable[..., Any]
    needs_colors: bool = False
    extras: tuple[str, ...] = ()


_SCHEDULERS: dict[str, SchedulerEntry] = {}


def register_scheduler(name: str, factory: Callable[..., Any], *,
                       needs_colors: bool = False,
                       extras: tuple[str, ...] = ()) -> SchedulerEntry:
    """Register a strategy; registering the same factory again is a
    no-op, a different factory under a taken name is an error."""
    prior = _SCHEDULERS.get(name)
    if prior is not None:
        if prior.factory is factory:
            return prior
        raise ValueError(f"scheduler name {name!r} is already registered "
                         f"to {prior.factory!r}")
    entry = SchedulerEntry(name=name, factory=factory,
                           needs_colors=needs_colors, extras=tuple(extras))
    _SCHEDULERS[name] = entry
    return entry


def _load_builtin() -> None:
    # the engine modules register themselves on import
    import repro_torch.core.engine_bsp  # noqa: F401
    import repro_torch.core.engine_chromatic  # noqa: F401
    import repro_torch.core.engine_locking  # noqa: F401
    import repro_torch.core.engine_priority  # noqa: F401


def get_scheduler(name: str) -> SchedulerEntry:
    _load_builtin()
    entry = _SCHEDULERS.get(name)
    if entry is None:
        waits = ("the sequential oracle is repro_torch.core."
                 "engine_sequential.run_sequential (tests only)"
                 if name == "sequential" else "ROADMAP A9 for the "
                 "distributed engines")
        raise ValueError(f"scheduler {name!r} is not registered in "
                         f"repro_torch ({waits}); registered: "
                         f"{list_schedulers()}")
    return entry


def list_schedulers() -> list[str]:
    _load_builtin()
    return sorted(_SCHEDULERS)
