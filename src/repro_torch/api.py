"""One paper-shaped entry point: data graph + update + sync -> run.

The port of ``repro.api``, the paper's programming surface (§3's data
graph, update function, sync operations, and an engine selected by
configuration):

    from repro_torch import api
    from repro_torch.apps import pagerank

    graph, update, syncs = pagerank.build(edges, n)
    result = api.run(graph, update, syncs=syncs,
                     scheduler="priority", k_select=64,
                     until=lambda g: g["total_rank"] < 1e-3)

* ``scheduler=`` names a strategy of the registry the engine modules
  self-register into (``repro_torch.core.registry``): ``chromatic`` /
  ``priority`` / ``bsp`` / ``locking`` / ``sequential`` (the Def. 3.1
  oracle).
* keywords are validated in one place against the registry entry: a
  knob the strategy would silently ignore raises ``ValueError`` naming
  the legal set.
* every run returns the same ``RunResult``, and ``until=`` ends a run on
  a predicate over the sync results (the paper's termination by sync);
  ``trace=`` records every superstep and ``profile=True`` times every
  superstep into a ``repro_torch.profile.TraceRecorder``.

* ``n_shards > 1`` (or an explicit ``partition=``) builds the
  strategy's distributed variant over a ``ShardPlan`` and runs its
  shards through a mesh (``mesh=``: a ``repro_torch.core.mesh``
  ``LocalMesh``, the default, on the run's device, or a
  ``ProcessGroupMesh``).

The port adds ``device=`` (default: the GPU, see ``resolve_device``; the
graph is moved there if it lives elsewhere) and keeps ``use_kernel=``
as a keyword.  Fault tolerance and online serving are not ported yet:
their keywords raise ``ValueError`` naming the ROADMAP item they wait
for (A10, A11).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.exec import EngineState, validate_dispatch
from repro_torch.core.registry import (describe_schedulers,
                                       get_distributed, get_scheduler,
                                       list_schedulers)
from repro_torch.core.sync import SyncOp, tree_map
from repro_torch.core.update import Consistency, UpdateFn
from repro_torch.device import resolve_device

__all__ = ["RunResult", "EngineSpec", "run", "build_engine",
           "list_schedulers", "describe_schedulers"]

PyTree = Any


# ----------------------------------------------------------------------
# RunResult: the one return convention
# ----------------------------------------------------------------------

@dataclasses.dataclass
class RunResult:
    """What every ``run`` returns, whatever the strategy.

    ``state`` is the final ``EngineState`` of an engine run, ``None`` for
    the sequential oracle, which also does not count supersteps
    (``superstep`` is ``None``).  ``active_any`` says whether tasks were
    left.  ``trace`` holds the per-superstep records when tracing was
    asked for; ``profile`` the ``TraceRecorder`` of timed step records
    when ``profile=True`` (save it, or fit a cost model with
    ``repro_torch.profile.fit_cost_model``).  ``stats`` carries
    strategy-specific extras (a distributed run's local shard data, and
    the locking engine's ghost traffic); ``restarts`` the supervised
    run's restart log, which waits for ROADMAP A10.
    """
    vertex_data: PyTree
    edge_data: PyTree | None
    globals: dict
    superstep: int | None
    n_updates: int
    active_any: bool | None = None
    state: EngineState | None = None
    engine: Any = None
    trace: list | None = None
    profile: Any = None
    stats: dict = dataclasses.field(default_factory=dict)
    restarts: list | None = None


# ----------------------------------------------------------------------
# EngineSpec: scheduler name + validated configuration
# ----------------------------------------------------------------------

@dataclasses.dataclass
class EngineSpec:
    """A resolved engine configuration (the ``set_*_type`` bundle).

    ``options`` holds the per-strategy knobs (``k_select``,
    ``max_pending``, ``use_kernel``, ``cost_model``, ...), validated
    against the registry entry at ``build`` time.  ``dispatch="auto"``
    (or ``None``) defers to the strategy's own default (the sweep
    engines pin ``"bucket"``, the window engines choose by the static
    rule or the cost model); ``"bucket"`` / ``"batch"`` force a launch
    shape.  ``consistency`` overrides the update function's declared
    scope model (the paper's ``set_scope_type``).
    """
    scheduler: str = "chromatic"
    n_shards: int = 1
    consistency: Consistency | str | None = None
    dispatch: str | None = "auto"
    max_supersteps: int | None = None
    options: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        validate_dispatch(self.dispatch)
        if (isinstance(self.n_shards, bool)
                or not isinstance(self.n_shards, int) or self.n_shards < 1):
            raise ValueError(
                f"n_shards must be a positive int, got {self.n_shards!r}")

    @property
    def entry(self) -> registry.SchedulerEntry:
        return get_scheduler(self.scheduler)

    # -- keyword normalization: one validator for every strategy -------
    def _factory_kwargs(self, entry) -> dict:
        kwargs = dict(self.options)
        if self.max_supersteps is not None:
            kwargs["max_supersteps"] = self.max_supersteps
        # "auto"/None defer to the strategy's registered default: the
        # sweep engines pin "bucket", and a forced mode is an explicit
        # choice
        if self.dispatch not in (None, "auto"):
            kwargs["dispatch"] = self.dispatch
        unknown = set(kwargs) - entry.allowed
        if unknown:
            storage = unknown & {"hub_split", "w_cap", "edge_locality",
                                 "bucket_widths"}
            if storage:
                raise ValueError(
                    f"{sorted(storage)} are graph-*storage* options, not "
                    "engine options: pass them to DataGraph.from_edges "
                    "(or an app builder such as pagerank.build) so the "
                    "graph is stored split before handing it to run()")
            dist = isinstance(entry, registry.DistributedEntry)
            raise ValueError(
                f"scheduler {self.scheduler!r}"
                f"{' (distributed)' if dist else ''} does not "
                f"accept {sorted(unknown)}; allowed options: "
                f"{sorted(entry.allowed)}")
        for key in ("max_pending", "k_select", "max_supersteps"):
            v = kwargs.get(key)
            # bool is an int subclass: k_select=True must not quietly
            # become a window of 1
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, int) or v < 1):
                raise ValueError(f"{key} must be a positive int, got {v!r}")
        return kwargs

    def _resolve_update(self, update_fn: UpdateFn) -> UpdateFn:
        if not isinstance(update_fn, UpdateFn):
            raise ValueError(
                f"update must be an UpdateFn, got {type(update_fn).__name__}"
                " (wrap the callable with repro_torch.core.update.UpdateFn "
                "or aggregator_update)")
        if self.consistency is None:
            return update_fn
        c = self.consistency
        if isinstance(c, str):
            try:
                c = Consistency(c.lower())
            except ValueError:
                raise ValueError(
                    f"unknown consistency {self.consistency!r}; expected "
                    f"one of {[m.value for m in Consistency]}") from None
        return dataclasses.replace(update_fn, consistency=c)

    def distributed(self, partition=None) -> bool:
        """Does this spec resolve to a distributed engine?  True for
        ``n_shards > 1``, and for an explicit ``partition=`` at
        ``n_shards == 1`` (the degenerate one-shard plan)."""
        return self.n_shards > 1 or partition is not None

    def build(self, graph, update_fn: UpdateFn,
              syncs: Sequence[SyncOp] = (), *, partition=None):
        """Resolve the registry entry and construct the engine.

        Without a ``partition=``, ``n_shards == 1`` builds the
        single-device strategy; otherwise the strategy's distributed
        variant is built over a ``ShardPlan``.  ``partition=`` is a
        ``[Nv]`` shard assignment, a callable ``(graph, n_shards) ->
        assignment``, a prebuilt ``ShardPlan``, ``"measured"`` (the
        cost-model-scored ``two_phase_partition``), or None for
        ``two_phase_partition(graph.n_vertices, graph.edges_np, n_shards,
        seed=0)`` (``edges_np`` is the graph's stored edge order).
        """
        update_fn = self._resolve_update(update_fn)
        if not self.distributed(partition):
            entry = get_scheduler(self.scheduler)
            self._check_colors(entry, graph)
            return entry.factory(graph, update_fn, syncs=tuple(syncs),
                                 **self._factory_kwargs(entry))
        from repro_torch.core.distributed import ShardPlan
        from repro_torch.core.partition import two_phase_partition
        dentry = get_distributed(self.scheduler)
        self._check_colors(get_scheduler(self.scheduler), graph)
        if isinstance(partition, ShardPlan):
            if partition.M != self.n_shards:
                raise ValueError(
                    f"partition= plan has M={partition.M} shards but "
                    f"n_shards={self.n_shards}")
            plan = partition
        else:
            if isinstance(partition, str):
                if partition != "measured":
                    raise ValueError(
                        f"unknown partition {partition!r}: the only "
                        "string form is 'measured' (cost-model-scored "
                        "two_phase_partition, DESIGN.md §11); otherwise "
                        "pass an assignment, a callable, or a ShardPlan")
                from repro_torch.profile.model import (load_cost_model,
                                                       resolve_cost_model)
                model = self.options.get("cost_model")
                model = (resolve_cost_model(model, graph.device.type)
                         if model is not None
                         else load_cost_model(graph.device.type))
                if model is None:
                    raise ValueError(
                        "partition='measured' needs a cost model: pass "
                        "cost_model=, or calibrate this device first "
                        "(python -m repro_torch.profile.calibrate)")
                assignment = two_phase_partition(
                    graph.n_vertices, graph.edges_np, self.n_shards,
                    seed=0, cost_model=model, w_cap=graph.ell.w_cap)
            elif callable(partition):
                assignment = partition(graph, self.n_shards)
            elif partition is None:
                assignment = two_phase_partition(
                    graph.n_vertices, graph.edges_np, self.n_shards,
                    seed=0)
            else:
                assignment = np.asarray(partition)
            plan = ShardPlan.build(graph, assignment, self.n_shards)
        return dentry.factory(graph, plan, update_fn, syncs=tuple(syncs),
                              **self._factory_kwargs(dentry))

    def _check_colors(self, entry, graph) -> None:
        if entry.needs_colors and graph.colors is None:
            raise ValueError(
                f"scheduler {self.scheduler!r} needs a colored graph; "
                "call graph.with_colors(...) (the locking engine "
                "handles colorless graphs)")


# ----------------------------------------------------------------------
# run(): the uniform run loop
# ----------------------------------------------------------------------

def build_engine(graph, update: UpdateFn, *, scheduler: str = "chromatic",
                 consistency=None, syncs: Sequence[SyncOp] = (),
                 n_shards: int = 1, dispatch: str | None = "auto",
                 max_pending: int | None = None,
                 max_supersteps: int | None = None, partition=None,
                 cost_model=None, device=None, **options):
    """Construct (but do not run) the engine ``run`` would drive, on
    ``device`` (default: the GPU; the graph moves there)."""
    device = resolve_device(device)
    if max_pending is not None:
        options["max_pending"] = max_pending
    if cost_model is not None:
        options["cost_model"] = _resolve_cost_model_option(cost_model,
                                                           device)
    spec = EngineSpec(scheduler=scheduler, n_shards=n_shards,
                      consistency=consistency, dispatch=dispatch,
                      max_supersteps=max_supersteps, options=options)
    if graph.device != device:
        graph = graph.to(device)
    return spec.build(graph, update, syncs, partition=partition)


def _resolve_cost_model_option(cost_model, device: torch.device):
    """Normalize ``cost_model=`` once, at the facade: strings resolve
    through ``repro_torch.profile.resolve_cost_model`` (``"measured"``
    is the calibration of the run's device type, a model path, or a
    plugin entry-point name), so engines only see a model instance."""
    from repro_torch.profile.model import resolve_cost_model
    return resolve_cost_model(cost_model, device.type)


# options of the reference's run that the port does not take yet, and
# the ROADMAP item each waits for
_NOT_PORTED = {
    "checkpoint_every": "A10",
    "checkpoint_dir": "A10", "resume_from": "A10", "faults": "A10",
    "max_restarts": "A10", "slack": "A11", "edge_capacity": "A11",
    "publish_every": "A11",
}


def run(graph, update: UpdateFn, *, scheduler: str = "chromatic",
        consistency=None, syncs: Sequence[SyncOp] = (), n_shards: int = 1,
        dispatch: str | None = "auto", max_pending: int | None = None,
        max_supersteps: int | None = None,
        until: Callable[[dict], bool] | None = None,
        num_supersteps: int | None = None, active=None, priority=None,
        trace=None, partition=None, profile: bool = False,
        cost_model=None, use_kernel: bool | None = None, device=None,
        **options) -> RunResult:
    """Run ``update`` over ``graph`` under the named scheduler.

    Termination is the earliest of the task set draining,
    ``max_supersteps`` (the engine's default: 100 for chromatic, BSP
    and the oracle, 1000 for priority, 2000 for locking), an explicit
    ``num_supersteps`` budget, or ``until(sync_globals) -> True``
    (termination by sync, evaluated before each superstep on the latest
    sync results).  ``active`` / ``priority`` seed the task set and its
    priorities (default: every vertex at priority 1).

    ``trace=True`` (or ``trace=fn``) records one entry a superstep: the
    default record is ``{"superstep", "n_updates", "active",
    "globals"}`` (globals as numpy arrays); a callable receives the
    ``EngineState`` and its return value is recorded instead.
    ``until`` / ``trace`` step the engine from the host, superstep by
    superstep, bitwise what a plain run computes.

    ``profile=True`` runs the same loop and also wall-clocks every
    superstep (the device drained before and after), recording its
    launch shape into a ``repro_torch.profile.TraceRecorder`` returned
    as ``RunResult.profile``; the first step at each shape is marked
    ``cold``.  ``cost_model=`` hands such a fitted model (or
    ``"measured"`` for the calibration persisted for this device type,
    a ``COSTMODEL_*.json`` path, or a plugin entry-point name) to
    ``dispatch="auto"``; it changes launch shapes only, never results.

    ``consistency=`` overrides the update's declared scope model.
    ``use_kernel=False`` runs the aggregator's dense arm (bitwise equal
    to the kernel arm).  Per-strategy extras (``k_select=``, ``fifo=``,
    ``max_pending=``, ``snapshot_phases=``, ...) pass through
    ``**options`` and are validated against the registry entry.
    """
    waiting = sorted(k for k in options if k in _NOT_PORTED)
    if waiting:
        raise ValueError(
            f"{waiting} are not ported to repro_torch yet (ROADMAP "
            f"{', '.join(sorted({_NOT_PORTED[k] for k in waiting}))})")
    if use_kernel is not None:
        options["use_kernel"] = use_kernel
    if trace is False:
        trace = None          # "tracing off", not a trace callable
    device = resolve_device(device)
    distributed = EngineSpec(scheduler=scheduler,
                             n_shards=n_shards).distributed(partition)
    if distributed:
        if until is not None or trace is not None or profile:
            raise ValueError(
                "until=/trace=/profile= step the engine from the host "
                "and are single-device only; a distributed run steps "
                "all of its shards inside the engine (n_shards=1 "
                "supports all three)")
        if priority is not None:
            raise ValueError("priority= initialization is single-device "
                             "only (shards derive priority from active)")
    engine = build_engine(
        graph, update, scheduler=scheduler, consistency=consistency,
        syncs=syncs, n_shards=n_shards, dispatch=dispatch,
        max_pending=max_pending, max_supersteps=max_supersteps,
        partition=partition, cost_model=cost_model, device=device,
        **options)
    if distributed:
        out = engine.run(active=active, num_supersteps=num_supersteps)
        main = ("vertex_data", "globals", "supersteps", "n_updates",
                "active_any")
        return RunResult(
            vertex_data=out["vertex_data"], edge_data=None,
            globals=out["globals"], superstep=out["supersteps"],
            n_updates=out["n_updates"], active_any=out["active_any"],
            engine=engine,
            stats={k: v for k, v in out.items() if k not in main})
    entry = get_scheduler(scheduler)

    if not entry.stepping:
        if trace is not None or profile:
            raise ValueError("trace=/profile= need a stepping engine; "
                             "the sequential oracle supports neither")
        if priority is not None:
            raise ValueError("priority= initialization is engine-only; "
                             "the sequential oracle derives priorities "
                             "from the active set")
        vdata, edata, globals_, n_updates, act = engine.run(
            active=active, num_supersteps=num_supersteps, until=until)
        return RunResult(vertex_data=vdata, edge_data=edata,
                         globals=globals_, superstep=None,
                         n_updates=n_updates,
                         active_any=bool(np.asarray(act).any()),
                         engine=engine)

    if until is None and trace is None and not profile:
        state = engine.run(active=active, priority=priority,
                           num_supersteps=num_supersteps)
        return _result_from_state(state, engine, None)

    recorder = None
    if profile:
        from repro_torch.profile.trace import TraceRecorder
        recorder = TraceRecorder(device=device.type)
        seen_shapes: set = set()
    trace_fn = _default_trace if trace is True else trace
    state = engine.init_state(active, priority)
    records = [] if trace is not None else None
    steps = 0
    while True:
        if num_supersteps is not None:
            if steps >= num_supersteps:
                break
        elif (not bool(state.active.any())
              or state.superstep >= engine.max_supersteps):
            break
        if until is not None and until(state.globals):
            break
        if recorder is not None:
            # probe the launch shape first (selection only), then time
            # the step itself; the first step at each shape may build a
            # kernel and is marked cold so fits skip it
            probe = engine.profile_probe(state)
            key = (probe["mode"], probe.get("width"), probe.get("rows"))
            _synchronize(device)
            t0 = time.perf_counter()
            state = engine._superstep(state)
            _synchronize(device)
            wall_us = (time.perf_counter() - t0) * 1e6
            recorder.record_step(wall_us=wall_us,
                                 cold=key not in seen_shapes,
                                 superstep=steps, **probe)
            seen_shapes.add(key)
        else:
            state = engine._superstep(state)
        steps += 1
        if records is not None:
            records.append(trace_fn(state))
    return _result_from_state(state, engine, records, recorder)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _result_from_state(state: EngineState, engine, trace,
                       profile=None) -> RunResult:
    return RunResult(
        vertex_data=state.vertex_data, edge_data=state.edge_data,
        globals=state.globals, superstep=int(state.superstep),
        n_updates=int(state.n_updates),
        active_any=bool(state.active.any()), state=state, engine=engine,
        trace=trace, profile=profile)


def _default_trace(state: EngineState) -> dict:
    return {"superstep": int(state.superstep),
            "n_updates": int(state.n_updates),
            "active": int(state.active.sum()),
            "globals": tree_map(_host_array, state.globals)}


def _host_array(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
