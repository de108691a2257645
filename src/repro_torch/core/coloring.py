"""Vertex colorings for the chromatic engine (paper §4.2.1).

A copy of ``repro.core.coloring``'s colorings: the same first-fit rule
in the same largest-degree-first order, so the colors are identical.  Host-side numpy; the adjacency is a CSR built
with numpy instead of Python lists of lists, which changes the speed
and not the result (the set of colors a vertex sees does not depend on
the order its neighbours are listed in).
"""
from __future__ import annotations

import numpy as np


def _csr(n_vertices: int, edges: np.ndarray):
    """Symmetric adjacency without self loops, duplicates kept (they
    count toward the degree, as in the reference's adjacency lists)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    edges = edges[edges[:, 0] != edges[:, 1]]
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(src, kind="stable")
    deg = np.bincount(src, minlength=n_vertices)
    indptr = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    return indptr, dst[order], deg


def greedy_coloring(n_vertices: int, edges: np.ndarray,
                    order: np.ndarray | None = None) -> np.ndarray:
    """First-fit greedy coloring: no adjacent vertices share a color."""
    indptr, nbrs, deg = _csr(n_vertices, edges)
    if order is None:
        # largest-degree-first tends to produce fewer colors
        order = np.argsort(-deg, kind="stable")
    ptr = indptr.tolist()
    adj = nbrs.tolist()
    colors = [-1] * n_vertices
    for v in np.asarray(order).tolist():
        used = {colors[u] for u in adj[ptr[v]:ptr[v + 1]]}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return np.asarray(colors, dtype=np.int32)


def distance2_coloring(n_vertices: int, edges: np.ndarray) -> np.ndarray:
    """Coloring of the square graph: no vertex shares a color with any
    neighbour at distance 1 or 2, which gives the *full* consistency
    model under the chromatic engine (paper §4.2.1).  The reference's
    adjacency is a set a vertex, so a duplicate edge counts once toward
    the largest-degree-first order: the adjacency here is deduplicated
    (``greedy_coloring`` keeps duplicates, as the reference's lists)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    edges = edges[edges[:, 0] != edges[:, 1]]
    pairs = np.unique(np.concatenate([edges, edges[:, ::-1]]), axis=0)
    indptr, nbrs, deg = _csr(n_vertices, pairs[pairs[:, 0] < pairs[:, 1]])
    ptr = indptr.tolist()
    adj = nbrs.tolist()
    colors = [-1] * n_vertices
    for v in np.argsort(-deg, kind="stable").tolist():
        used = set()
        for u in adj[ptr[v]:ptr[v + 1]]:
            used.add(colors[u])
            used.update(colors[w] for w in adj[ptr[u]:ptr[u + 1]] if w != v)
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return np.asarray(colors, dtype=np.int32)


def single_color(n_vertices: int) -> np.ndarray:
    """All vertices one color: the vertex consistency model (independent
    map operations), and the BSP engine's Jacobi sweeps."""
    return np.zeros(n_vertices, dtype=np.int32)


def bipartite_coloring(n_left: int, n_vertices: int) -> np.ndarray:
    """Two-coloring of a bipartite graph with left block [0, n_left)."""
    colors = np.zeros(n_vertices, dtype=np.int32)
    colors[n_left:] = 1
    return colors


def verify_coloring(n_vertices: int, edges: np.ndarray, colors: np.ndarray,
                    distance: int = 1) -> bool:
    """Property check used by tests: valid (distance-1 or -2) coloring."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    colors = np.asarray(colors)
    real = edges[:, 0] != edges[:, 1]
    if (colors[edges[real, 0]] == colors[edges[real, 1]]).any():
        return False
    if distance == 2:
        indptr, nbrs, _ = _csr(n_vertices, edges)
        for v in range(n_vertices):
            for u in nbrs[indptr[v]:indptr[v + 1]]:
                two = nbrs[indptr[u]:indptr[u + 1]]
                two = two[two != v]
                if (colors[two] == colors[v]).any():
                    return False
    return True
