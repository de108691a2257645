"""Online graph serving: live mutations + dirty-scope incremental
recompute + snapshot-isolated query traffic (DESIGN.md §13).

The port of ``repro.serve.graph_engine``.  A long-lived
:class:`ServingEngine` wraps any registered scheduler, driven as::

    serving = api.serve(graph, update, syncs=syncs, scheduler="locking")
    serving.recompute()                      # initial convergence
    eid = serving.add_edge(u, v, w=0.3)      # mutations ...
    serving.update_vertex_data([v], {"rank": [1.0]})
    serving.recompute()                      # ... dirty scopes only
    serving.top_k("rank", 10)                # queries (snapshot reads)

Three moving parts:

* **Mutation log onto slack storage.**  Mutations apply to a private
  working graph at once: ``add_edges`` lands in the reserved slack slots
  of ``from_edges(slack=...)`` storage through ``core.graph
  .insert_edges`` (no rebuild, no shape change); data writes replace
  rows.  When a row or the reserved edge rows run out, the engine falls
  back to a compaction rebuild (``rebuild_compacted``) that reserves
  slack again and keeps input-order edge ids.
* **Dirty-scope tracking -> scheduler task set.**  Each mutation records
  the vertices whose update inputs it invalidated (a vertex write: its
  1-hop closure; an edge write: the two endpoints; an insert: the 1-hop
  closure of both endpoints).  ``recompute`` seeds the scheduler's
  ``active=`` with that mask, so convergence reuses the task-set algebra
  (and, under the window schedulers, the ``[B, W]`` batch launches)
  instead of whole-graph sweeps, stepping through
  ``ExecutorCore.step_on`` against the mutated structure.
* **Snapshot isolation for reads.**  Queries read a
  :class:`GraphSnapshot` published only at recompute boundaries
  (superstep boundaries are globally consistent cuts, paper §8;
  ``publish_every=`` also publishes mid-recompute cuts).

Tensors are mutable where JAX arrays are not, so isolation is a rule of
this code, not a property of the arrays: nothing here, in
``insert_edges`` or in the engines writes a tensor in place.  Every
mutation writes a new tensor (``index_put`` / ``index_copy`` return
one), the engines' supersteps return new tensors, and ``_publish`` keeps
the tensors it is handed without copying them; a pinned snapshot's
tensors are therefore never written again.  The cost is one copy of
each written field a mutating call (the reference's ``.at[].set``
copies the same bytes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.coloring import greedy_coloring
from repro_torch.core.exec import dirty_scope_mask, init_engine_state
from repro_torch.core.graph import (DataGraph, input_order_edges,
                                    insert_edges, rebuild_compacted)

PyTree = Any


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ----------------------------------------------------------------------
# GraphSnapshot: the published read view
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GraphSnapshot:
    """A consistent view of converged data for queries.

    Published at recompute boundaries; its tensors are never written
    again (see the module docstring).  ``edge_inv_perm`` / ``n_edges``
    are captured with the data so edge reads stay right across later
    inserts and compactions; the edge index dict is shared (it only
    grows, and entries past ``n_edges`` are ignored here).
    """
    vertex_data: PyTree
    edge_data: PyTree
    globals: dict
    n_vertices: int
    n_edges: int
    round: int                 # recompute round that published this view
    superstep: int             # cumulative supersteps at publish time
    _edge_inv_perm: np.ndarray = dataclasses.field(repr=False)
    _edge_index: dict = dataclasses.field(repr=False)

    # -- queries -------------------------------------------------------
    def read_vertex(self, ids, field: str | None = None):
        """Vertex data rows at ``ids`` (a field, or every field), as
        numpy arrays."""
        ids = np.asarray(ids)
        if field is not None:
            return _host(self.vertex_data[field])[ids]
        return {k: _host(v)[ids] for k, v in self.vertex_data.items()}

    def find_edge(self, u: int, v: int) -> int | None:
        """Input-order edge id of ``{u, v}`` in this view, or None."""
        eid = self._edge_index.get((min(int(u), int(v)), max(int(u), int(v))))
        return eid if eid is not None and eid < self.n_edges else None

    def read_edge(self, u: int, v: int, field: str | None = None):
        """Edge data of ``{u, v}``; ``KeyError`` if absent in this view."""
        eid = self.find_edge(u, v)
        if eid is None:
            raise KeyError(f"no edge {{{u}, {v}}} in snapshot "
                           f"(round {self.round})")
        row = int(self._edge_inv_perm[eid])
        if field is not None:
            return _host(self.edge_data[field][row])
        return {k: _host(v[row]) for k, v in self.edge_data.items()}

    def top_k(self, field: str, k: int, largest: bool = True):
        """Top-``k`` vertices by a scalar vertex field: ``(ids, values)``."""
        vals = _host(self.vertex_data[field])
        if vals.ndim != 1:
            raise ValueError(f"top_k needs a scalar field, {field!r} has "
                             f"shape {vals.shape[1:]} per vertex")
        order = np.argsort(-vals if largest else vals, kind="stable")[:k]
        return order, vals[order]


# ----------------------------------------------------------------------
# ServingEngine
# ----------------------------------------------------------------------

class ServingEngine:
    """Long-lived mutate / recompute / query loop over one scheduler.

    Construct through :func:`repro_torch.api.serve` (which validates the
    scheduler configuration and ensures slack storage).  ``spec`` is the
    validated ``api.EngineSpec``; ``partition=`` goes to distributed
    builds (``n_shards > 1``), which build their engine again every
    round (the ShardPlan depends on structure) and need updates that
    write vertex data only: no edge data flows back from the shards,
    the working graph's copy stays authoritative.
    """

    def __init__(self, graph: DataGraph, update_fn, syncs: Sequence = (),
                 *, spec, partition=None, publish_every: int | None = None):
        if graph.slack <= 0:
            raise ValueError(
                "ServingEngine needs mutable storage: build the graph "
                "with slack (api.serve does this automatically)")
        self._graph = graph
        self._update = update_fn
        self._syncs = tuple(syncs)
        self._spec = spec
        self._partition = partition
        self.publish_every = publish_every
        # colors are kept up only when the scheduler reads them
        # (chromatic, priority): a recolor builds a new engine
        self._track_colors = (graph.colors is not None
                              and getattr(spec.entry, "needs_colors", False))
        self._colors = (graph.colors.cpu().numpy().copy()
                        if self._track_colors else None)
        self._colors_version = 0
        self._engines: dict = {}       # (colors_version, ell meta) -> engine
        edges_in, _ = input_order_edges(graph)
        self._edge_index: dict[tuple[int, int], int] = {
            (min(u, v), max(u, v)): i
            for i, (u, v) in enumerate(edges_in.tolist())}
        # dirty bookkeeping: closure seeds get their 1-hop scope, exact
        # seeds only themselves (DESIGN.md §13)
        self._dirty_closure: set[int] = set()
        self._dirty_exact: set[int] = set()
        self._round = 0
        self._supersteps = 0
        self._snapshot: GraphSnapshot | None = None
        self._last_state = None
        self.last_launches: list[dict] | None = None
        self.stats = {
            "edges_inserted": 0, "slack_inserts": 0, "compactions": 0,
            "vertex_updates": 0, "edge_updates": 0, "recolors": 0,
            "rounds": 0, "supersteps": 0, "updates": 0,
        }
        self._publish()

    # -- introspection (working graph, not the snapshot) ---------------
    @property
    def graph(self) -> DataGraph:
        """The current working graph (mutations applied, perhaps not yet
        converged).  Queries should go through ``snapshot()``."""
        return self._graph

    @property
    def n_edges(self) -> int:
        return self._graph.n_edges

    def degrees(self) -> np.ndarray:
        return self._graph.degree.cpu().numpy()

    def neighbors(self, v: int):
        """Current neighbours of ``v``: ``(nbr_ids, edge_input_ids)``."""
        g = self._graph
        rows = g.struct_rows(torch.tensor([int(v)], dtype=torch.int32,
                                          device=g.device))
        m = rows.nbr_mask[0]
        nbrs = rows.nbrs[0][m].cpu().numpy()
        eids = g.edge_perm[rows.edge_ids[0][m].cpu().numpy()]
        return nbrs, eids

    def find_edge(self, u: int, v: int) -> int | None:
        eid = self._edge_index.get((min(int(u), int(v)), max(int(u), int(v))))
        return eid if eid is not None and eid < self._graph.n_edges else None

    # -- mutations ------------------------------------------------------
    def add_edges(self, edges, edge_data: Mapping | None = None) -> np.ndarray:
        """Insert undirected edges; returns their input-order edge ids.

        The fast path fills slack slots (no rebuild, no shape change);
        when the slack runs out a compaction rebuild reserves it again.
        Readers keep the last snapshot either way.  Duplicate edges
        raise (change an existing edge with ``update_edge_data``).
        """
        edges = np.asarray(edges, np.int64).reshape(-1, 2)
        if len(edges) == 0:
            return np.empty((0,), np.int64)
        keys = [(min(int(u), int(v)), max(int(u), int(v))) for u, v in edges]
        for key in keys:
            if self.find_edge(*key) is not None:
                raise ValueError(
                    f"edge {{{key[0]}, {key[1]}}} already exists; use "
                    "update_edge_data to change its data")
        if len(set(keys)) != len(keys):
            raise ValueError("duplicate edges within one add_edges batch")
        ne = self._graph.n_edges
        g2 = insert_edges(self._graph, edges, edge_data)
        if g2 is None:
            self._graph = rebuild_compacted(self._graph, extra_edges=edges,
                                            extra_edge_data=edge_data)
            self.stats["compactions"] += 1
            if self._colors is not None:
                ein, _ = input_order_edges(self._graph)
                self._set_colors(greedy_coloring(self._graph.n_vertices, ein))
        else:
            self._graph = g2
            self.stats["slack_inserts"] += len(edges)
            if self._colors is not None:
                self._fix_colors(edges)
        if self._colors is not None:
            self._graph = self._graph.with_colors(self._colors)
        new_ids = np.arange(ne, ne + len(edges), dtype=np.int64)
        for key, eid in zip(keys, new_ids.tolist()):
            self._edge_index[key] = eid
        self._dirty_closure.update(edges.reshape(-1).tolist())
        self.stats["edges_inserted"] += len(edges)
        return new_ids

    def add_edge(self, u: int, v: int, **fields) -> int:
        data = ({k: np.asarray([val]) for k, val in fields.items()}
                if fields else None)
        return int(self.add_edges(np.asarray([[u, v]]), data)[0])

    def update_vertex_data(self, ids, values: Mapping) -> None:
        """Write vertex-data rows: ``values`` maps field -> ``[m, ...]``
        rows for the ``m`` vertices in ``ids``.  Dirties the 1-hop
        scopes of the written vertices."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self._graph.n_vertices):
            raise ValueError(
                f"vertex ids must be in [0, {self._graph.n_vertices})")
        rows = torch.from_numpy(ids).to(self._graph.device)
        vdata = dict(self._graph.vertex_data)
        for field, vals in values.items():
            if field not in vdata:
                raise KeyError(
                    f"unknown vertex field {field!r}; graph has "
                    f"{sorted(vdata)}")
            old = vdata[field]
            vdata[field] = old.index_put((rows,), torch.as_tensor(
                np.asarray(vals)).to(old.device, old.dtype))
        self._graph = dataclasses.replace(self._graph, vertex_data=vdata)
        self._dirty_closure.update(ids.tolist())
        self.stats["vertex_updates"] += int(ids.size)

    def update_edge_data(self, edge_ids, values: Mapping) -> None:
        """Write edge-data rows by input-order edge id (from
        ``find_edge`` / ``add_edges`` / ``neighbors``).  Dirties exactly
        the edges' endpoints, the only scopes that read edge data."""
        edge_ids = np.asarray(edge_ids, np.int64).reshape(-1)
        if edge_ids.size == 0:
            return
        if edge_ids.min() < 0 or edge_ids.max() >= self._graph.n_edges:
            raise ValueError(
                f"edge ids must be in [0, {self._graph.n_edges})")
        stored = np.asarray(self._graph.edge_inv_perm)[edge_ids]
        rows = torch.from_numpy(stored).to(self._graph.device)
        edata = dict(self._graph.edge_data)
        for field, vals in values.items():
            if field not in edata:
                raise KeyError(
                    f"unknown edge field {field!r}; graph has "
                    f"{sorted(edata)}")
            old = edata[field]
            edata[field] = old.index_put((rows,), torch.as_tensor(
                np.asarray(vals)).to(old.device, old.dtype))
        self._graph = dataclasses.replace(self._graph, edge_data=edata)
        self._dirty_exact.update(
            self._graph.edges_np[stored].reshape(-1).tolist())
        self.stats["edge_updates"] += int(edge_ids.size)

    def update_edge(self, u: int, v: int, **fields) -> None:
        eid = self.find_edge(u, v)
        if eid is None:
            raise KeyError(f"no edge {{{u}, {v}}}; add_edge it first")
        self.update_edge_data(
            [eid], {k: np.asarray([val]) for k, val in fields.items()})

    # -- chromatic upkeep ----------------------------------------------
    def _set_colors(self, colors: np.ndarray) -> None:
        self._colors = np.asarray(colors, np.int32)
        self._colors_version += 1
        self.stats["recolors"] += 1

    def _fix_colors(self, new_edges: np.ndarray) -> None:
        """Local greedy repair: an insert joining same-colored endpoints
        moves one endpoint to the smallest color free in its (new)
        neighbourhood.  Keeps the coloring proper; the count may grow."""
        changed = False
        for u, v in new_edges.tolist():
            if self._colors[u] != self._colors[v]:
                continue
            nbrs, _ = self.neighbors(u)
            used = set(self._colors[nbrs].tolist())
            c = 0
            while c in used:
                c += 1
            self._colors = self._colors.copy()
            self._colors[u] = c
            changed = True
        if changed:
            self._colors_version += 1
            self.stats["recolors"] += 1

    # -- recompute ------------------------------------------------------
    def dirty_mask(self) -> np.ndarray:
        """The ``[Nv]`` bool task-set seed the next recompute will use."""
        mask = np.zeros((self._graph.n_vertices,), bool)
        if self._dirty_closure:
            mask |= dirty_scope_mask(
                self._graph, np.fromiter(self._dirty_closure, np.int64)
            ).cpu().numpy()
        if self._dirty_exact:
            mask[np.fromiter(self._dirty_exact, np.int64)] = True
        return mask

    def _engine(self):
        ell = self._graph.ell
        key = (self._colors_version, ell.widths, tuple(ell.starts),
               ell.n_rows, ell.pad_edge)
        eng = self._engines.get(key)
        if eng is None:
            eng = self._spec.build(self._graph, self._update, self._syncs)
            self._engines[key] = eng
        return eng

    def recompute(self, *, full: bool | None = None,
                  max_supersteps: int | None = None,
                  track_launches: bool = False) -> dict:
        """Re-converge the dirty scopes; publish a fresh snapshot.

        ``full=`` seeds every vertex instead of the dirty mask (``None``
        chooses full for the first round, when nothing has converged
        yet).  ``track_launches=True`` records the launch shape of each
        superstep's first phase (a probe: one more selection a
        superstep) into the returned stats and ``self.last_launches``.
        Returns ``{"round", "supersteps", "updates", "dirty",
        "launches"}``.
        """
        if full is None:
            full = self._round == 0
        if full:
            mask = np.ones((self._graph.n_vertices,), bool)
        else:
            mask = self.dirty_mask()
        self._dirty_closure.clear()
        self._dirty_exact.clear()
        n_dirty = int(mask.sum())
        if n_dirty == 0:
            self._publish()
            return {"round": self._round, "supersteps": 0, "updates": 0,
                    "dirty": 0, "launches": []}
        if self._spec.distributed(self._partition):
            return self._recompute_distributed(mask, max_supersteps)
        engine = self._engine()
        g = self._graph
        state = init_engine_state(
            g.vertex_data, g.edge_data, g.n_vertices, self._syncs,
            g.device, active=torch.from_numpy(mask).to(g.device))
        cap = max_supersteps or engine.max_supersteps
        launches: list[dict] = []
        steps = 0
        while steps < cap and bool(state.active.any()):
            if track_launches:
                launches.append(engine.probe_on(g, state))
            state = engine.step_on(g, state)
            steps += 1
            if (self.publish_every and steps % self.publish_every == 0
                    and bool(state.active.any())):
                self._fold(state)
                self._publish(superstep_delta=steps)
        self._fold(state)
        self._last_state = state
        self._round += 1
        self._supersteps += steps
        n_upd = int(state.n_updates)
        self.stats["rounds"] += 1
        self.stats["supersteps"] += steps
        self.stats["updates"] += n_upd
        self.last_launches = launches if track_launches else None
        self._publish()
        return {"round": self._round, "supersteps": steps,
                "updates": n_upd, "dirty": n_dirty, "launches": launches}

    def _recompute_distributed(self, mask: np.ndarray,
                               max_supersteps: int | None) -> dict:
        spec = self._spec
        if max_supersteps is not None:
            spec = dataclasses.replace(spec, max_supersteps=max_supersteps)
        engine = spec.build(self._graph, self._update, self._syncs,
                            partition=self._partition)
        out = engine.run(active=mask)
        self._graph = dataclasses.replace(self._graph,
                                          vertex_data=out["vertex_data"])
        self._round += 1
        steps = int(out["supersteps"])
        self._supersteps += steps
        self.stats["rounds"] += 1
        self.stats["supersteps"] += steps
        self.stats["updates"] += int(out["n_updates"])
        self.last_launches = None
        self._publish(globals_=out["globals"])
        return {"round": self._round, "supersteps": steps,
                "updates": int(out["n_updates"]),
                "dirty": int(mask.sum()), "launches": []}

    def _fold(self, state) -> None:
        """Fold an EngineState back into the working graph: after this,
        ``graph.vertex_data`` / ``edge_data`` *are* the serving values."""
        self._graph = dataclasses.replace(
            self._graph, vertex_data=state.vertex_data,
            edge_data=state.edge_data)

    def _publish(self, globals_: dict | None = None,
                 superstep_delta: int = 0) -> None:
        g = self._graph
        if globals_ is None:
            globals_ = {s.key: s.run(g.vertex_data) for s in self._syncs}
        self._snapshot = GraphSnapshot(
            vertex_data=dict(g.vertex_data),
            edge_data=dict(g.edge_data),
            globals=globals_,
            n_vertices=g.n_vertices,
            n_edges=g.n_edges,
            round=self._round,
            superstep=self._supersteps + superstep_delta,
            _edge_inv_perm=np.asarray(g.edge_inv_perm),
            _edge_index=self._edge_index)

    # -- queries (delegate to the published snapshot) ------------------
    def snapshot(self) -> GraphSnapshot:
        """Pin the current published view: later mutations and
        recomputes never change what this handle reads."""
        return self._snapshot

    def read_vertex(self, ids, field: str | None = None):
        return self._snapshot.read_vertex(ids, field)

    def read_edge(self, u: int, v: int, field: str | None = None):
        return self._snapshot.read_edge(u, v, field)

    def top_k(self, field: str, k: int, largest: bool = True):
        return self._snapshot.top_k(field, k, largest)

    # -- persistence ----------------------------------------------------
    def save_snapshot(self, path: str) -> None:
        """Persist the last converged EngineState (single-device rounds)
        through ``repro_torch.train.checkpoint.snapshot_engine_state``."""
        if self._last_state is None:
            raise ValueError("nothing to save: run recompute() first "
                             "(distributed rounds keep state sharded)")
        from repro_torch.train.checkpoint import snapshot_engine_state
        snapshot_engine_state(path, self._last_state)
