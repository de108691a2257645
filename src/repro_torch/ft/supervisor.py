"""Supervised execution: retry with exponential backoff + restore (the
port of ``repro.ft.supervisor``, unchanged: it is host Python).

The supervisor is deliberately dumb (Distributed GraphLab §5 restarts
the whole run from the last snapshot; so do we): it calls an *attempt
function* until one attempt returns, retrying on the restartable
exception set with exponentially-backed-off sleeps, and keeps a
structured :class:`RestartRecord` log that ends up on
``RunResult.restarts``.  Where to restore from is the attempt
function's business (``repro_torch.ft.runner`` restores from the latest
valid snapshot) — the supervisor only decides *whether to try again*.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

from repro_torch.ft.faults import InjectedFault


@dataclasses.dataclass
class RestartRecord:
    """One supervised restart: which attempt died, of what, how long we
    backed off, and (filled by the attempt function) which superstep
    the next attempt restored to — ``None`` means from scratch."""
    attempt: int
    error_type: str
    error: str
    backoff_s: float
    restored_superstep: int | None = None


class SupervisorGaveUp(Exception):
    """More failures than ``max_restarts``; the last error is chained."""


def supervised(attempt_fn: Callable, *, max_restarts: int = 3,
               backoff_base_s: float = 0.01, backoff_factor: float = 2.0,
               backoff_max_s: float = 1.0,
               restartable: Sequence[type] = (InjectedFault,),
               sleep: Callable[[float], None] = time.sleep):
    """Run ``attempt_fn(attempt_no, restarts) -> result`` under
    restart-on-failure.  Returns ``(result, restarts)``.

    ``restarts`` is the shared restart log; the record for the failure
    that caused the current attempt is ``restarts[-1]``, which the
    attempt function should annotate with ``restored_superstep`` once
    it knows where it resumed from.
    """
    restartable = tuple(restartable)
    restarts: list[RestartRecord] = []
    attempt = 0
    while True:
        try:
            return attempt_fn(attempt, restarts), restarts
        except restartable as e:
            if attempt >= max_restarts:
                raise SupervisorGaveUp(
                    f"giving up after {attempt} restart(s); last error: "
                    f"{type(e).__name__}: {e}") from e
            backoff = min(backoff_base_s * backoff_factor ** attempt,
                          backoff_max_s)
            restarts.append(RestartRecord(
                attempt=attempt, error_type=type(e).__name__,
                error=str(e), backoff_s=backoff))
            sleep(backoff)
            attempt += 1
