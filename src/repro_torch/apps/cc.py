"""Connected components by min-label propagation (int32, exact).

The port of ``repro.apps.cc``.  Vertex data: {"label": int32},
initialized to the vertex id (or any injected labels).  The update takes
the minimum over the scope and reschedules the neighbours on change:
chaotic iteration over a confluent semilattice, so every scheduler
reaches the same fixed point (the per-component minimum), and integer
min has no rounding: runs are compared bitwise across engines, devices
and frameworks.  No aggregator is declared on purpose (the kernel path
is a float32 weighted sum); the dense scope path is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.coloring import greedy_coloring
from repro_torch.core.graph import DataGraph
from repro_torch.core.update import (Consistency, ScopeBatch, UpdateFn,
                                     UpdateResult)

_INT32_MAX = np.iinfo(np.int32).max


def make_update() -> UpdateFn:
    def fn(scope: ScopeBatch) -> UpdateResult:
        nbr = torch.where(scope.nbr_mask, scope.nbr_data["label"], _INT32_MAX)
        new = torch.minimum(scope.v_data["label"], nbr.min(dim=1).values)
        changed = new < scope.v_data["label"]
        return UpdateResult(
            v_data={"label": new},
            resched_nbrs=changed[:, None] & scope.nbr_mask,
        )

    return UpdateFn(fn, Consistency.EDGE, name="cc")


def make_graph(edges: np.ndarray, n_vertices: int, *,
               labels: np.ndarray | None = None, max_deg: int | None = None,
               colors: np.ndarray | None = None, slack: int = 0,
               edge_capacity: int | None = None, device=None) -> DataGraph:
    """The CC data graph, greedily colored (or with ``colors``, e.g. a
    coloring of the same edges computed before); ``slack=`` /
    ``edge_capacity=`` reserve mutable storage for ``api.serve``."""
    if labels is None:
        labels = np.arange(n_vertices, dtype=np.int32)
    g = DataGraph.from_edges(
        n_vertices, edges,
        vertex_data={"label": np.asarray(labels, np.int32)},
        max_deg=max_deg, slack=slack, edge_capacity=edge_capacity,
        device=device)
    if colors is None:
        colors = greedy_coloring(n_vertices, edges)
    return g.with_colors(colors)


def build(edges: np.ndarray, n_vertices: int, *,
          labels: np.ndarray | None = None, max_deg: int | None = None,
          colors: np.ndarray | None = None, slack: int = 0,
          edge_capacity: int | None = None, device=None):
    """Uniform facade triple ``(graph, update, syncs)``; no syncs —
    termination is the task set draining at the fixed point."""
    graph = make_graph(edges, n_vertices, labels=labels, max_deg=max_deg,
                       colors=colors, slack=slack,
                       edge_capacity=edge_capacity, device=device)
    return graph, make_update(), ()


def reference_components(edges: np.ndarray, n_vertices: int,
                         labels: np.ndarray | None = None) -> np.ndarray:
    """Union-find oracle: each vertex's fixed-point label is the least
    injected label of its connected component.

    The reference's union-find, vectorized over the edges so it runs at
    millions of edges: every round hooks the larger root of each edge
    under the smaller one, then halves every path by pointer jumping,
    until no edge joins two roots.  Only the partition into components
    matters, so the labels are the reference's."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    parent = np.arange(n_vertices, dtype=np.int64)
    u, v = edges[:, 0], edges[:, 1]
    while True:
        while True:                              # compress to roots
            grand = parent[parent]
            if np.array_equal(grand, parent):
                break
            parent = grand
        ru, rv = parent[u], parent[v]
        cross = ru != rv
        if not cross.any():
            break
        lo = np.minimum(ru[cross], rv[cross])
        hi = np.maximum(ru[cross], rv[cross])
        np.minimum.at(parent, hi, lo)
    if labels is None:
        labels = np.arange(n_vertices, dtype=np.int32)
    best = np.full(n_vertices, _INT32_MAX, dtype=np.int64)
    np.minimum.at(best, parent, np.asarray(labels, np.int64))
    return best[parent].astype(np.int32)
