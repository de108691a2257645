"""Checkpointed, supervised run drivers: what ``api.run(...,
checkpoint_every= / resume_from= / faults= / max_restarts=)`` routes to.

The port of ``repro.ft.runner``.  Both drivers share one shape: an
*attempt function* (restore from the newest valid snapshot, else start
fresh) wrapped in ``repro_torch.ft.supervisor.supervised``.  The
distributed driver runs the engine in chunks (``step_chunk``), cut at
checkpoint multiples and at the fault plan's next trigger; each chunk
continues from the previous chunk's carry with the same supersteps, so
chunked == whole == resumed, bitwise (``tests/test_torch_ft.py``).
"""
from __future__ import annotations

import os
from glob import glob
from typing import Any, Callable

from repro_torch.ft import snapshot as snap
from repro_torch.ft.supervisor import supervised


def _chunk_target(step: int, limit: int, checkpoint_every: int | None,
                  faults) -> int:
    """Where the next chunk must stop: the run limit, capped to the
    next checkpoint multiple and the next fault trigger."""
    target = limit
    if checkpoint_every:
        target = min(target, (step // checkpoint_every + 1)
                     * checkpoint_every)
    if faults is not None:
        nt = faults.next_trigger(step)
        if nt is not None:
            target = min(target, nt)
    return target


# ----------------------------------------------------------------------
# Distributed runs: the engine's carry, chunk by chunk
# ----------------------------------------------------------------------

def run_distributed(engine, *, scheduler: str, active=None,
                    num_supersteps: int | None = None,
                    checkpoint_every: int | None = None,
                    checkpoint_dir: str | None = None,
                    resume_from: str | None = None,
                    faults=None, max_restarts: int = 3,
                    backoff_base_s: float = 0.01,
                    sleep: Callable[[float], None] | None = None
                    ) -> tuple[dict, list]:
    """Drive a distributed engine to completion under checkpointing,
    fault injection and supervised restart.  Returns
    ``(engine.finalize(carry), restart log)``.

    ``num_supersteps`` is a *total* budget (a resumed run does not
    restart the count) and runs regardless of the task set; without it
    the run drains the task set or reaches ``engine.max_supersteps``,
    as ``engine.run()`` does.  Under a ``ProcessGroupMesh`` every rank
    calls this with the same plan of faults; they fire on every rank at
    the same boundary, so no rank waits in a collective for a dead one.
    """
    plan, mesh = engine.plan, engine.mesh
    limit = (num_supersteps if num_supersteps is not None
             else engine.max_supersteps)
    ignore_active = num_supersteps is not None
    expect = dict(expect_partition=plan.partition_fingerprint,
                  expect_scheduler=scheduler)
    if faults is not None:
        engine.fault_hook = faults.fire

    def attempt(attempt_no: int, restarts: list):
        carry = None
        if attempt_no == 0 and resume_from is not None:
            carry, _ = snap.load_carry(resume_from, engine.init_carry(active),
                                       mesh=mesh, **expect)
        elif attempt_no > 0 and checkpoint_dir is not None:
            latest = snap.latest_valid_snapshot(
                checkpoint_dir, expect_n_shards=plan.M, mesh=mesh, **expect)
            if latest is not None:
                carry, step = snap.load_carry(
                    latest, engine.init_carry(active), mesh=mesh, **expect)
                restarts[-1].restored_superstep = step
        if carry is None:
            carry = engine.init_carry(active)

        while True:
            step = carry["superstep"]
            # the boundary hook also fires inside step_chunk; firing
            # here first covers the paths that stop before stepping
            if faults is not None:
                faults.fire("superstep", superstep=step)
            if step >= limit:
                break
            if not ignore_active and not engine.carry_active_any(carry):
                break
            target = _chunk_target(step, limit, checkpoint_every, faults)
            carry = engine.step_chunk(carry, target, ignore_active)
            step = carry["superstep"]
            if (checkpoint_every and checkpoint_dir
                    and step % checkpoint_every == 0):
                snap.write_snapshot(
                    checkpoint_dir, carry, scheduler=scheduler,
                    partition=plan.partition_fingerprint,
                    assignment=plan.assignment, faults=faults, mesh=mesh)
        return carry

    kwargs = {} if sleep is None else {"sleep": sleep}
    carry, restarts = supervised(attempt, max_restarts=max_restarts,
                                 backoff_base_s=backoff_base_s, **kwargs)
    return engine.finalize(carry), restarts


# ----------------------------------------------------------------------
# Single-device runs: superstep by superstep over EngineState
# ----------------------------------------------------------------------

def _latest_valid_state(ckpt_dir: str, like) -> tuple[Any, str | None]:
    """Newest restorable ``state_step_*.npz`` under ``ckpt_dir``
    (corrupt or mismatched ones are skipped, as
    ``latest_valid_snapshot`` skips directories)."""
    from repro_torch.train.checkpoint import (CheckpointError,
                                              restore_engine_state)
    for f in sorted(glob(os.path.join(ckpt_dir, "state_step_*.npz")),
                    reverse=True):
        try:
            return restore_engine_state(f, like), f
        except CheckpointError:
            continue
    return None, None


def run_single(engine, *, active=None, priority=None,
               until: Callable[[dict], bool] | None = None,
               num_supersteps: int | None = None,
               checkpoint_every: int | None = None,
               checkpoint_dir: str | None = None,
               resume_from: str | None = None,
               faults=None, max_restarts: int = 3,
               backoff_base_s: float = 0.01,
               sleep: Callable[[float], None] | None = None):
    """Single-device counterpart of :func:`run_distributed`: steps
    ``engine._superstep`` one superstep at a time (the loop the facade's
    ``until=`` / ``trace=`` path runs), with atomic
    ``snapshot_engine_state`` checkpoints.  Returns ``(EngineState,
    restart log)``."""
    from repro_torch.train.checkpoint import (restore_engine_state,
                                              snapshot_engine_state)

    def attempt(attempt_no: int, restarts: list):
        state = None
        if attempt_no == 0 and resume_from is not None:
            state = restore_engine_state(
                resume_from, engine.init_state(active, priority))
        elif attempt_no > 0 and checkpoint_dir is not None:
            state, _ = _latest_valid_state(
                checkpoint_dir, engine.init_state(active, priority))
            if state is not None:
                restarts[-1].restored_superstep = int(state.superstep)
        if state is None:
            state = engine.init_state(active, priority)

        while True:
            step = state.superstep
            if faults is not None:
                faults.fire("superstep", superstep=step)
            if num_supersteps is not None:
                if step >= num_supersteps:
                    break
            elif (not bool(state.active.any())
                  or step >= engine.max_supersteps):
                break
            if until is not None and until(state.globals):
                break
            state = engine._superstep(state)
            step = state.superstep
            if (checkpoint_every and checkpoint_dir
                    and step % checkpoint_every == 0):
                if faults is not None:
                    faults.fire("checkpoint_write", superstep=step)
                snapshot_engine_state(
                    os.path.join(checkpoint_dir,
                                 f"state_step_{step:08d}.npz"), state)
        return state

    kwargs = {} if sleep is None else {"sleep": sleep}
    return supervised(attempt, max_restarts=max_restarts,
                      backoff_base_s=backoff_base_s, **kwargs)
