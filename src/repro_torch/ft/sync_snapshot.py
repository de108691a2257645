"""The paper-fidelity snapshot: a snapshot *as a GraphLab program*.

The port of ``repro.ft.sync_snapshot``.  Paper §8: "a globally
consistent snapshot mechanism can be easily performed using the Sync
operation", and Distributed GraphLab §5 spells it out: the snapshot is
itself an update function scheduled over every vertex.
``repro_torch.ft.snapshot`` is the engineering path (copy the carry at
a superstep boundary); this module is the paper's path: each vertex's
update copies its own data into shadow ``snap__<field>`` columns under
VERTEX consistency, one superstep over the full task set commits the
cut, and the shadow columns *are* the snapshot.  Both express the same
consistency argument, a superstep boundary is a global cut, and
``tests/test_torch_ft.py`` holds them bitwise equal.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.update import Consistency, UpdateFn, UpdateResult


def snapshot_update(fields: Sequence[str]) -> UpdateFn:
    """The snapshot program: copy own data into shadow columns.

    VERTEX consistency: the snapshot reads and writes only the central
    vertex, so any engine may run every vertex in one conflict-free
    sweep.  No rescheduling: the task set drains after one pass."""
    fields = tuple(fields)

    def fn(scope) -> UpdateResult:
        v = dict(scope.v_data)
        for k in fields:
            v[f"snap__{k}"] = scope.v_data[k]
        return UpdateResult(v_data=v)

    return UpdateFn(fn, consistency=Consistency.VERTEX, name="snapshot")


def snapshot_as_program(graph, *, fields: Sequence[str] | None = None,
                        scheduler: str = "chromatic", n_shards: int = 1,
                        partition=None, **options) -> dict:
    """Take a consistent snapshot of ``graph.vertex_data`` by running the
    §8 snapshot program through the named engine; returns ``{field:
    snapshotted tensor}``.

    The graph is widened with zeroed ``snap__*`` shadow columns, the
    snapshot update runs for exactly one superstep over all vertices,
    and the shadows are stripped back out.  ``options`` go to
    ``api.run`` (``device=`` among them)."""
    from repro_torch import api

    fields = tuple(fields if fields is not None
                   else graph.vertex_data.keys())
    shadow = {f"snap__{k}": torch.zeros_like(graph.vertex_data[k])
              for k in fields}
    widened = dataclasses.replace(
        graph, vertex_data={**graph.vertex_data, **shadow})
    res = api.run(widened, snapshot_update(fields), scheduler=scheduler,
                  n_shards=n_shards, partition=partition,
                  num_supersteps=1, **options)
    return {k: res.vertex_data[f"snap__{k}"] for k in fields}
