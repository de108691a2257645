"""String-keyed engine registry: scheduler names -> execution strategies.

The port of ``repro.core.registry``.  Every engine module
self-registers its strategy here at import (``register_scheduler``, and
``register_distributed`` for its sharded variant), declaring the keyword arguments it accepts:
the *shared* set every strategy understands plus its per-strategy
*extras* (``k_select`` and ``fifo`` for priority, ``max_pending`` for
locking, ...).  ``repro_torch.api`` resolves a scheduler name through
``get_scheduler`` and validates the caller's keywords against the entry
in one place, so a keyword an engine would silently ignore raises a
``ValueError`` naming the legal set.

Registered: ``chromatic``, ``bsp``, ``priority``, ``locking`` and
``sequential`` (the Def. 3.1 oracle); distributed (``n_shards > 1``):
``chromatic`` and ``locking``.  The two tables are separate halves
joined at lookup, so import order is free.  Out-of-tree strategies and
cost models resolve through package entry points in the groups
``repro_torch.schedulers`` and ``repro_torch.cost_models``.
"""
from __future__ import annotations

import dataclasses
import importlib.metadata
from typing import Any, Callable

# Keyword arguments every registered single-device strategy understands:
# the reference's set less ``kernel_interpret`` (a Pallas interpret-mode
# switch with no CUDA meaning).  ``device`` is a run argument of the
# facade, not an engine option.
SHARED_KWARGS = ("max_supersteps", "use_kernel", "dispatch", "cost_model")
# The distributed variants also take the shard-plan knobs: the
# reference's ``axis`` (a shard_map axis name) becomes ``mesh``, the
# ``repro_torch.core.mesh`` object the shards exchange through.
SHARED_DIST_KWARGS = SHARED_KWARGS + ("exchange_edges", "mesh")


@dataclasses.dataclass(frozen=True)
class _Entry:
    """A registered factory and its keyword surface: ``shared + extras``
    is exactly what the facade accepts for it; anything else is a
    ``ValueError``."""
    name: str
    factory: Callable[..., Any]
    shared: tuple[str, ...] = SHARED_KWARGS
    extras: tuple[str, ...] = ()

    @property
    def allowed(self) -> frozenset:
        return frozenset(self.shared) | frozenset(self.extras)


@dataclasses.dataclass(frozen=True)
class SchedulerEntry(_Entry):
    """One registered scheduling strategy.

    ``factory(graph, update_fn, syncs=..., **kwargs)`` builds a runner
    exposing ``run(active=None, priority=None, num_supersteps=None)``.
    ``stepping`` says the runner is an ``ExecutorCore`` (``EngineState``
    / ``_superstep``), which ``until=`` / ``trace=`` / ``profile=``
    stepping needs; the sequential oracle sets it False.
    """
    needs_colors: bool = False
    stepping: bool = True
    description: str = ""


@dataclasses.dataclass(frozen=True)
class DistributedEntry(_Entry):
    """The sharded variant of a scheduler: ``factory(graph, plan,
    update_fn, syncs=..., **kwargs)`` over a prebuilt ``ShardPlan``."""
    shared: tuple[str, ...] = SHARED_DIST_KWARGS


_SCHEDULERS: dict[str, SchedulerEntry] = {}
_DISTRIBUTED: dict[str, DistributedEntry] = {}


def _same_factory(a, b) -> bool:
    """Identity, or the same (module, qualname): reloading an engine
    module re-runs its ``register_scheduler`` with a new class object
    for the same strategy, which must stay idempotent.  Lambdas and
    nested functions share qualnames like ``<lambda>``, so for those
    only identity counts."""
    if a is b:
        return True
    key = lambda f: (getattr(f, "__module__", None),
                     getattr(f, "__qualname__", None))
    (ma, qa), (mb, qb) = key(a), key(b)
    if ma is None or qa is None or "<" in qa:
        return False
    return (ma, qa) == (mb, qb)


def _guard_duplicate(table: dict, name: str, factory):
    """Registering the same strategy again returns the existing entry
    untouched; a different factory under a taken name would be a silent
    engine swap, and raises."""
    prior = table.get(name)
    if prior is None:
        return None
    if _same_factory(prior.factory, factory):
        return prior
    raise ValueError(
        f"scheduler name {name!r} is already registered to "
        f"{prior.factory!r}; pick a different name")


def register_scheduler(name: str, factory: Callable[..., Any], *,
                       shared: tuple[str, ...] = SHARED_KWARGS,
                       extras: tuple[str, ...] = (),
                       needs_colors: bool = False,
                       stepping: bool = True,
                       description: str = "") -> SchedulerEntry:
    prior = _guard_duplicate(_SCHEDULERS, name, factory)
    if prior is not None:
        return prior
    entry = SchedulerEntry(name=name, factory=factory, shared=tuple(shared),
                           extras=tuple(extras), needs_colors=needs_colors,
                           stepping=stepping, description=description)
    _SCHEDULERS[name] = entry
    return entry


def register_distributed(name: str, factory: Callable[..., Any], *,
                         shared: tuple[str, ...] = SHARED_DIST_KWARGS,
                         extras: tuple[str, ...] = ()) -> DistributedEntry:
    prior = _guard_duplicate(_DISTRIBUTED, name, factory)
    if prior is not None:
        return prior
    entry = DistributedEntry(name=name, factory=factory, shared=tuple(shared),
                             extras=tuple(extras))
    _DISTRIBUTED[name] = entry
    return entry


def _ensure_registered() -> None:
    # the engine modules register themselves on import
    import repro_torch.core.engine_bsp  # noqa: F401
    import repro_torch.core.distributed  # noqa: F401
    import repro_torch.core.engine_chromatic  # noqa: F401
    import repro_torch.core.engine_locking  # noqa: F401
    import repro_torch.core.engine_priority  # noqa: F401
    import repro_torch.core.engine_sequential  # noqa: F401


# ----------------------------------------------------------------------
# Plugin discovery: out-of-tree strategies via package entry points
# ----------------------------------------------------------------------
#
# A package declaring
#
#     [project.entry-points."repro_torch.schedulers"]
#     myengine = "mypkg.engine:register"
#
# makes ``api.run(..., scheduler="myengine")`` work: on a registry miss
# the entry point is loaded, given a chance to self-register, and the
# lookup retried.  ``repro_torch.cost_models`` entry points resolve the
# same way for ``cost_model="..."`` strings (``profile/model.py``).

SCHEDULER_PLUGIN_GROUP = "repro_torch.schedulers"


def _iter_entry_points(group: str):
    """All installed entry points in ``group`` (tests monkeypatch it)."""
    try:
        return tuple(importlib.metadata.entry_points(group=group))
    except Exception:
        return ()


def load_plugin(group: str, name: str):
    """Load entry point ``name`` from ``group``; None if not installed."""
    for ep in _iter_entry_points(group):
        if ep.name == name:
            return ep.load()
    return None


def _try_plugin_scheduler(name: str) -> bool:
    """Resolve a registry miss through ``repro_torch.schedulers`` entry
    points.  The loaded object may have self-registered on import;
    failing that, a callable is called for a factory, which is
    registered under ``name``.  Returns whether ``name`` is registered
    now."""
    obj = load_plugin(SCHEDULER_PLUGIN_GROUP, name)
    if obj is None:
        return False
    if name not in _SCHEDULERS and callable(obj):
        produced = obj()
        if name not in _SCHEDULERS:
            if not callable(produced):
                raise ValueError(
                    f"entry point {SCHEDULER_PLUGIN_GROUP!r}:{name!r} "
                    f"neither registered a scheduler nor returned a "
                    f"factory (got {produced!r})")
            register_scheduler(name, produced,
                               description=f"plugin ({obj.__module__})")
    return name in _SCHEDULERS


def get_scheduler(name: str) -> SchedulerEntry:
    _ensure_registered()
    try:
        return _SCHEDULERS[name]
    except KeyError:
        if _try_plugin_scheduler(name):
            return _SCHEDULERS[name]
        raise ValueError(
            f"unknown scheduler {name!r}; registered schedulers: "
            f"{', '.join(list_schedulers())}") from None


def get_distributed(name: str) -> DistributedEntry:
    _ensure_registered()
    if name not in _SCHEDULERS:
        # same error text as get_scheduler: unknown beats undistributable
        get_scheduler(name)
    try:
        return _DISTRIBUTED[name]
    except KeyError:
        raise ValueError(
            f"scheduler {name!r} has no distributed (n_shards > 1) "
            f"engine; distributed schedulers: "
            f"{', '.join(sorted(_DISTRIBUTED))}") from None


def list_schedulers() -> list[str]:
    """Registered scheduler names, sorted (the paper's §3.4 menu)."""
    _ensure_registered()
    return sorted(_SCHEDULERS)


def describe_schedulers() -> dict[str, str]:
    _ensure_registered()
    return {n: _SCHEDULERS[n].description for n in sorted(_SCHEDULERS)}
