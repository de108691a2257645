"""Deterministic fault injection for distributed runs (the port of
``repro.ft.faults``, unchanged: it is host Python and numpy).

A :class:`FaultPlan` is a list of seeded, one-shot events fired from
*host-side* hook sites (DESIGN.md §12) — device code never branches
on the plan, so a run with ``faults=None`` pays nothing and a run with
faults launches the same kernels:

* site ``"superstep"`` — fired by the engines' ``step_chunk`` at a
  superstep boundary, before launching the next chunk.  ``kill``
  raises :class:`InjectedKill` (a shard process dying mid-run),
  ``transient`` raises :class:`TransientFault` (a recoverable host
  error), ``straggle`` sleeps ``delay_s`` (a delayed ghost exchange:
  the boundary is where ghost data ships, so delaying the boundary IS
  delaying the exchange).
* site ``"checkpoint_write"`` — fired between per-shard snapshot file
  writes; ``checkpoint_fail`` raises :class:`CheckpointWriteFault`,
  leaving the snapshot tmp directory torn (the atomicity test).

Events fire **once** (``fired`` flips) so the supervisor's replay after
a restart does not re-kill the run at the same boundary — exactly how
a real crashed-once process behaves.  ``next_trigger`` tells the
driver where to split its chunks so a fault at superstep k interrupts
the run at k, not at the next checkpoint multiple.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

_BOUNDARY_KINDS = ("kill", "transient", "straggle")
KINDS = _BOUNDARY_KINDS + ("checkpoint_fail",)


class InjectedFault(Exception):
    """Base of every injected failure (the supervisor's default
    restartable set)."""


class InjectedKill(InjectedFault):
    """A shard process killed at a superstep boundary."""


class TransientFault(InjectedFault):
    """A transient host-loop error (flaky RPC, OOM-retry, ...)."""


class CheckpointWriteFault(InjectedFault):
    """A failure in the middle of writing a snapshot."""


@dataclasses.dataclass
class FaultEvent:
    kind: str                 # kill | transient | straggle | checkpoint_fail
    superstep: int            # boundary at (or after) which it fires
    shard: int = 0            # which shard "dies" (recorded, not selective:
                              # the plan fires on every rank at once)
    delay_s: float = 0.0      # straggle sleep
    fired: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")


class FaultPlan:
    """An ordered set of one-shot fault events."""

    def __init__(self, events: Sequence[FaultEvent]):
        self.events = list(events)
        self.log: list[str] = []

    @classmethod
    def seeded(cls, seed: int, *, n_shards: int, max_superstep: int,
               n_events: int = 1,
               kinds: Sequence[str] = ("kill",)) -> "FaultPlan":
        """Deterministically sample ``n_events`` events: uniform kind
        from ``kinds``, superstep in [1, max_superstep), shard in
        [0, n_shards)."""
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_events):
            events.append(FaultEvent(
                kind=str(rng.choice(list(kinds))),
                superstep=int(rng.integers(1, max(2, max_superstep))),
                shard=int(rng.integers(max(1, n_shards))),
                delay_s=float(rng.uniform(0.001, 0.01))))
        return cls(events)

    def next_trigger(self, step: int) -> int | None:
        """Earliest unfired boundary-event superstep strictly after
        ``step`` — the driver caps its chunk there."""
        pending = [e.superstep for e in self.events
                   if not e.fired and e.kind in _BOUNDARY_KINDS
                   and e.superstep > step]
        return min(pending) if pending else None

    def fire(self, site: str, *, superstep: int,
             shard: int | None = None) -> None:
        """Fire every due, unfired event for ``site``.  Raises for
        kill/transient/checkpoint_fail; sleeps for straggle."""
        for e in self.events:
            if e.fired or superstep < e.superstep:
                continue
            if site == "superstep" and e.kind in _BOUNDARY_KINDS:
                e.fired = True
                self.log.append(f"{e.kind}@{superstep}(shard {e.shard})")
                if e.kind == "kill":
                    raise InjectedKill(
                        f"injected kill of shard {e.shard} at superstep "
                        f"{superstep}")
                if e.kind == "transient":
                    raise TransientFault(
                        f"injected transient fault at superstep "
                        f"{superstep}")
                time.sleep(e.delay_s)       # straggle, then continue
            elif site == "checkpoint_write" and e.kind == "checkpoint_fail":
                e.fired = True
                self.log.append(
                    f"checkpoint_fail@{superstep}(shard {shard})")
                raise CheckpointWriteFault(
                    f"injected checkpoint-write failure at superstep "
                    f"{superstep}, shard file {shard}")

    @property
    def all_fired(self) -> bool:
        return all(e.fired for e in self.events)
