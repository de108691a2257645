"""Sequential reference executor — the oracle for Def. 3.1 (the port of
``repro.core.engine_sequential.run_sequential``).

Executes update tasks strictly one at a time, calling the *same* update
function with a batch of one.  A parallel engine is sequentially
consistent iff its data graph equals this executor's, bit for bit (for a
deterministic update function).  Host-side and used only by tests.

The oracle replays each engine's RemoveNext policy (§3.4):

* default             — the chromatic engine's (superstep, color, id)
  order;
* ``k_select=K``      — the priority engine's: each superstep the K
  highest-priority active vertices (ties by lower id, the engines'
  stable sort), swept color by color;
* ``locking_pending=P`` — the locking engine's: the P highest-priority
  active vertices are pending and the min-id claim winners under the
  update's consistency model execute;
* ``snapshot_phases`` — every phase's scopes are gathered from a
  snapshot taken at phase start: with the single coloring, the BSP
  engine's Jacobi semantics.

``SequentialEngine`` puts the oracle behind the facade as the
``"sequential"`` scheduler.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.graph import DataGraph
from repro_torch.core.registry import register_scheduler
from repro_torch.core.sync import SyncOp
from repro_torch.core.update import (Consistency, UpdateFn, gather_scopes,
                                     scatter_result)


def _locking_winners(cand: list[int], adj, consistency: Consistency,
                     nv: int) -> list[int]:
    """Replay of the engines' claim pass: min-id claim winners among the
    pending window ``cand`` under the update's consistency model."""
    if consistency == Consistency.FULL:
        claim = {}
        for v in cand:
            for x in [v] + adj[v]:
                claim[x] = min(claim.get(x, nv + 1), v)
        return [v for v in cand
                if claim[v] == v and all(claim[u] == v for u in adj[v])]
    if consistency == Consistency.EDGE:
        cset = set(cand)
        return [v for v in cand
                if all(u not in cset or u > v for u in adj[v])]
    return list(cand)       # VERTEX / UNSAFE: no conflicts


def _by_priority(act: np.ndarray, prio: np.ndarray, k: int) -> np.ndarray:
    """The ``k`` highest-priority vertices, ties by lower id, inactive
    ones scoring -inf (the engines' ``stable_top_k``)."""
    score = np.where(act, prio, -np.inf)
    return np.argsort(-score, kind="stable")[:k]


def run_sequential(
    graph: DataGraph,
    update_fn: UpdateFn,
    syncs: Sequence[SyncOp] = (),
    active: np.ndarray | None = None,
    max_supersteps: int = 100,
    k_select: int | None = None,
    locking_pending: int | None = None,
    snapshot_phases: bool = False,
    until=None,
    return_active: bool = False,
):
    """Returns ``(vertex_data, edge_data, globals, n_updates)``, plus the
    final ``active`` task mask when ``return_active``.

    ``until(globals) -> bool`` ends the run before a superstep whose
    latest sync results satisfy it (a predicate true at the start
    executes nothing).
    """
    nv = graph.n_vertices
    if locking_pending is None:
        if graph.colors is None:
            raise ValueError(
                "sequential replay of color-ordered strategies needs a "
                "colored graph; call graph.with_colors(...) or pass "
                "locking_pending for the colorless locking replay")
        colors = graph.colors.cpu().numpy()
        n_colors = int(colors.max()) + 1 if colors.size else 1
        per_color = [np.nonzero(colors == c)[0] for c in range(n_colors)]
    else:
        # the locking engine ignores colors: one conflict-resolved phase
        colors, n_colors, per_color = None, 1, None
        adj = graph.adjacency_lists
    vdata, edata = graph.vertex_data, graph.edge_data
    act = (np.ones(nv, bool) if active is None
           else np.asarray(torch.as_tensor(active).cpu()).astype(bool))
    prio = act.astype(np.float32)
    globals_ = {s.key: s.run(vdata) for s in syncs}
    n_updates = 0
    one = torch.ones((1,), dtype=torch.bool, device=graph.device)

    for step in range(max_supersteps):
        if not act.any():
            break
        if until is not None and until(globals_):
            break
        winners = chosen = None
        if locking_pending is not None:
            cand = [int(v) for v in _by_priority(act, prio, locking_pending)
                    if act[v]]
            winners = _locking_winners(cand, adj, update_fn.consistency, nv)
        elif k_select is not None:
            chosen = _by_priority(act, prio, k_select)
            chosen = chosen[act[chosen]]          # mask -inf rows out
        for c in range(n_colors):
            # the phase's selection is taken at phase start, as the
            # engines take it: tasks added during phase c run later
            if winners is not None:
                sel = winners
            elif chosen is None:
                sel = [int(v) for v in per_color[c] if act[v]]
            else:
                sel = [int(v) for v in chosen if colors[v] == c]
            snap = (vdata, edata)
            # the engines consume and reschedule at batch granularity:
            # every executed task is consumed, then every returned task
            # is merged, so a same-phase reschedule survives the
            # target's own consumption
            resched: dict[int, float] = {}
            for v in sel:
                ids = torch.tensor([v], dtype=torch.int32, device=graph.device)
                src_v, src_e = snap if snapshot_phases else (vdata, edata)
                scope = gather_scopes(graph, src_v, src_e, ids, globals_)
                res = update_fn(scope)
                vdata, edata = scatter_result(graph, vdata, edata, ids, one,
                                              scope, res)
                pr = (float(res.priority[0]) if res.priority is not None
                      else -np.inf)
                if res.resched_self is not None and bool(res.resched_self[0]):
                    resched[v] = max(resched.get(v, -np.inf), pr)
                if res.resched_nbrs is not None:
                    nmask = (scope.nbr_mask[0] & res.resched_nbrs[0]).cpu()
                    for nb in scope.nbr_ids[0].cpu()[nmask].tolist():
                        resched[nb] = max(resched.get(nb, -np.inf), pr)
                n_updates += 1
            act[sel] = False
            prio[sel] = 0.0
            for u, pr in resched.items():
                act[u] = True
                if np.isfinite(pr):
                    prio[u] = max(prio[u], pr)
        for s in syncs:
            if (step + 1) % max(s.tau, 1) == 0:
                globals_[s.key] = s.run(vdata)
    if return_active:
        return vdata, edata, globals_, n_updates, act
    return vdata, edata, globals_, n_updates


class SequentialEngine:
    """The oracle as a registered strategy behind ``repro_torch.api``:
    ``scheduler="sequential"`` builds one, with the same keywords as the
    engines it replays (``k_select`` the priority engine's RemoveNext,
    ``max_pending`` the locking engine's pending window,
    ``snapshot_phases`` the BSP engine's Jacobi semantics).  Stateless
    across runs, like ``run_sequential``."""

    def __init__(self, graph: DataGraph, update_fn: UpdateFn,
                 syncs: Sequence[SyncOp] = (), max_supersteps: int = 100,
                 k_select: int | None = None,
                 max_pending: int | None = None,
                 snapshot_phases: bool = False):
        self.graph = graph
        self.update_fn = update_fn
        self.syncs = syncs
        self.max_supersteps = max_supersteps
        self.k_select = k_select
        self.max_pending = max_pending
        self.snapshot_phases = snapshot_phases

    def run(self, active=None, num_supersteps: int | None = None,
            until=None):
        """``run_sequential``'s ``(vertex_data, edge_data, globals,
        n_updates)`` plus the final task mask."""
        steps = (num_supersteps if num_supersteps is not None
                 else self.max_supersteps)
        return run_sequential(
            self.graph, self.update_fn, syncs=self.syncs, active=active,
            max_supersteps=steps, k_select=self.k_select,
            locking_pending=self.max_pending,
            snapshot_phases=self.snapshot_phases, until=until,
            return_active=True)


register_scheduler(
    "sequential", SequentialEngine,
    shared=("max_supersteps",),
    extras=("k_select", "max_pending", "snapshot_phases"),
    stepping=False,
    description="one-task-at-a-time oracle (Def. 3.1); replays "
                "chromatic / priority (k_select) / locking (max_pending) "
                "/ BSP (snapshot_phases) RemoveNext orders")
