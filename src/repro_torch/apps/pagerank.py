"""PageRank (paper Ex. 3.1 / Alg. 1) — the running example, on the port.

Vertex data: {"rank": R(v)}.  Edge data: {"w": w_{u,v}}, one symmetric
weight ``1/sqrt(deg_u * deg_v)`` per undirected edge.  The update is
Alg. 1: recompute the weighted sum of neighbor ranks; if
|old - new| > eps, reschedule the neighbors.  The neighbourhood sum is
declared as a ``NeighborAggregator``, so the engine runs it through the
``ell_spmv`` CUDA kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.coloring import greedy_coloring
from repro_torch.core.graph import DataGraph
from repro_torch.core.sync import sum_sync, top_two_sync
from repro_torch.core.update import (Consistency, ScopeBatch, UpdateFn,
                                     UpdateResult, aggregator_update)

ALPHA = 0.15


def make_update(eps: float = 1e-4) -> UpdateFn:
    def feature(vertex_data):
        return vertex_data["rank"][..., None]          # [..., 1]

    def weight(scope: ScopeBatch):
        return scope.edge_data["w"]                    # [B, D]

    def combine(scope: ScopeBatch, y) -> UpdateResult:
        new_rank = ALPHA + (1.0 - ALPHA) * y[..., 0]   # Alg. 1
        delta = torch.abs(new_rank - scope.v_data["rank"])
        changed = delta > eps
        return UpdateResult(
            v_data={"rank": new_rank},
            resched_nbrs=changed[:, None].expand(scope.nbr_mask.shape),
            priority=delta,
        )

    return aggregator_update(feature, weight, combine, Consistency.EDGE,
                             name="pagerank")


def _degrees(edges: np.ndarray, n_vertices: int) -> np.ndarray:
    """Float64 degrees (duplicates count twice), floored at 1."""
    deg = (np.bincount(edges[:, 0], minlength=n_vertices)
           + np.bincount(edges[:, 1], minlength=n_vertices))
    return np.maximum(deg.astype(np.float64), 1)


def edge_weights(edges: np.ndarray, n_vertices: int) -> np.ndarray:
    """``1/sqrt(deg_u * deg_v)`` per edge, in float64 and then cast to
    float32 — the reference's per-edge loop, vectorized; both round the
    same float64 values once, so the weights are bitwise equal."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    deg = _degrees(edges, n_vertices)
    return (1.0 / np.sqrt(deg[edges[:, 0]] * deg[edges[:, 1]])).astype(
        np.float32)


def make_graph(edges: np.ndarray, n_vertices: int, *,
               hub_split: bool = False, w_cap: int | None = None,
               colors: np.ndarray | None = None,
               device=None) -> DataGraph:
    """A colored PageRank data graph with symmetric normalized weights.
    ``hub_split=True`` (or an explicit ``w_cap=``) stores rows wider than
    ``w_cap`` as virtual rows (``DataGraph.from_edges``).  The colors
    are greedy (the reference's) unless ``colors`` gives a coloring the
    caller already has."""
    g = DataGraph.from_edges(
        n_vertices, edges,
        vertex_data={"rank": np.ones(n_vertices, np.float32)},
        edge_data={"w": edge_weights(edges, n_vertices)},
        edge_locality=False,
        hub_split=hub_split,
        w_cap=w_cap,
        device=device,
    )
    return g.with_colors(greedy_coloring(n_vertices, edges)
                         if colors is None else colors)


def build(edges: np.ndarray, n_vertices: int, *, eps: float = 1e-4,
          tau: int = 1, hub_split: bool = False, w_cap: int | None = None,
          colors: np.ndarray | None = None, device=None):
    """Uniform facade triple ``(graph, update, syncs)`` for
    ``repro_torch.api.run``; the syncs are the paper's §3.3 examples
    (second most popular page + total rank), refreshed every ``tau``
    supersteps.  ``hub_split``, ``w_cap`` and ``colors`` as in
    ``make_graph``."""
    graph = make_graph(edges, n_vertices, hub_split=hub_split, w_cap=w_cap,
                       colors=colors, device=device)
    syncs = (second_most_popular_sync(tau), total_rank_sync(tau))
    return graph, make_update(eps), syncs


def second_most_popular_sync(tau: int = 1):
    """The paper's §3.3 example sync: second most popular page."""
    return top_two_sync("top2", rank_fn=lambda row: row["rank"], tau=tau)


def total_rank_sync(tau: int = 1):
    return sum_sync("total_rank", lambda row: row["rank"], tau=tau)


def reference_pagerank(edges: np.ndarray, n_vertices: int,
                       n_iters: int = 200) -> np.ndarray:
    """Float64 fixed-point oracle for tests (same weights), as a sparse
    product: ``r <- ALPHA + (1 - ALPHA) * W r`` iterated."""
    r = np.ones(n_vertices)
    for _ in range(n_iters):
        r = ALPHA + (1 - ALPHA) * sparse_matvec(edges, n_vertices, r)
    return r


def sparse_matvec(edges: np.ndarray, n_vertices: int,
                  r: np.ndarray) -> np.ndarray:
    """``W r`` in float64 for the symmetric weight matrix W of
    ``edge_weights`` (duplicate edges add up)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    deg = _degrees(edges, n_vertices)
    u, v = edges[:, 0], edges[:, 1]
    w = 1.0 / np.sqrt(deg[u] * deg[v])
    return (np.bincount(u, weights=w * r[v], minlength=n_vertices)
            + np.bincount(v, weights=w * r[u], minlength=n_vertices))
