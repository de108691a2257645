"""Two-phase distributed graph partitioning (paper §4.1), on the port.

The port of ``repro.core.partition`` (numpy, host side).  Phase 1
over-partitions the graph into k >> M *atoms* by BFS region growing;
phase 2 builds the weighted *meta-graph* (atom weight = data size, edge
weight = cut edges) and balances the atoms onto M machines with a greedy
LPT + affinity heuristic.  Phase 1 does not depend on M, so one
over-partitioning serves any cluster size.

For the same inputs and seed every assignment is bitwise the
reference's.  The BFS is the reference's loop, step for step, over a
CSR adjacency held in Python lists (the reference's list of lists, in
the same order), which keeps a 2^21-vertex graph to seconds; the
meta-graph's cut counts are one ``np.unique`` instead of a loop over
the edges.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.core.graph import bucket_index, default_bucket_widths


@dataclasses.dataclass
class MetaGraph:
    k: int
    vertex_weight: np.ndarray       # [k] data size per atom
    edge_weight: dict               # {(a, b): #cut edges}, a < b
    atom_of: np.ndarray             # [Nv] atom assignment


def _adjacency_csr(n_vertices: int, edges: np.ndarray):
    """``(start, flat)`` as Python lists: vertex ``x``'s neighbours are
    ``flat[start[x]:start[x+1]]``, in the order the reference appends
    them (edge by edge, self loops left out)."""
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    e = e[e[:, 0] != e[:, 1]]
    src = e.reshape(-1)                      # u0, v0, u1, v1, ...
    dst = e[:, ::-1].reshape(-1)             # v0, u0, v1, u1, ...
    order = np.argsort(src, kind="stable")
    start = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n_vertices), out=start[1:])
    return start.tolist(), dst[order].tolist()


def _weights_as_scalars(vertex_weight: np.ndarray) -> list:
    """The weights the BFS adds one at a time: Python numbers where they
    round as the reference's numpy scalars do (float64 and integers),
    numpy scalars otherwise (a float32 sum stays float32)."""
    vw = np.asarray(vertex_weight)
    if vw.dtype == np.float64 or vw.dtype.kind in "iub":
        return vw.tolist()
    return list(vw)


def over_partition(n_vertices: int, edges: np.ndarray, k: int,
                   vertex_weight: np.ndarray | None = None,
                   seed: int = 0) -> np.ndarray:
    """BFS region growing into k atoms of ~equal weight."""
    if vertex_weight is None:
        vertex_weight = np.ones(n_vertices)
    start, flat = _adjacency_csr(n_vertices, edges)
    target = vertex_weight.sum() / k
    weight = _weights_as_scalars(vertex_weight)
    atom_of = [-1] * n_vertices
    rng = np.random.default_rng(seed)
    order = rng.permutation(n_vertices).tolist()
    cur_atom, cur_w = 0, 0.0
    frontier: deque[int] = deque()
    ptr = 0
    while True:
        if not frontier:
            while ptr < n_vertices and atom_of[order[ptr]] >= 0:
                ptr += 1
            if ptr >= n_vertices:
                break
            frontier.append(order[ptr])
        v = frontier.popleft()
        if atom_of[v] >= 0:
            continue
        atom_of[v] = cur_atom
        cur_w += weight[v]
        for u in flat[start[v]: start[v + 1]]:
            if atom_of[u] < 0:
                frontier.append(u)
        if cur_w >= target and cur_atom < k - 1:
            cur_atom += 1
            cur_w = 0.0
            frontier.clear()
    return np.asarray(atom_of, dtype=np.int64)


def build_meta_graph(atom_of: np.ndarray, edges: np.ndarray, k: int,
                     vertex_weight: np.ndarray | None = None) -> MetaGraph:
    nv = len(atom_of)
    if vertex_weight is None:
        vertex_weight = np.ones(nv)
    vw = np.zeros(k)
    np.add.at(vw, atom_of, vertex_weight)
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    a, b = atom_of[e[:, 0]], atom_of[e[:, 1]]
    cut = a != b
    lo, hi = np.minimum(a, b)[cut], np.maximum(a, b)[cut]
    keys, first, counts = np.unique(lo * k + hi, return_index=True,
                                    return_counts=True)
    # the reference's dict fills in order of each pair's first cut edge
    ew = {(int(key // k), int(key % k)): int(c)
          for key, c in zip(keys[np.argsort(first)],
                            counts[np.argsort(first)])}
    return MetaGraph(k=k, vertex_weight=vw, edge_weight=ew, atom_of=atom_of)


def balance_meta_graph(meta: MetaGraph, n_machines: int) -> np.ndarray:
    """Greedy LPT with edge-affinity tie-breaking: assign heavy atoms
    first to the least-loaded machine, preferring machines already
    holding neighbouring atoms (reduces the cut, i.e. ghost volume)."""
    k = meta.k
    nbrs: list[dict] = [dict() for _ in range(k)]
    for (a, b), w in meta.edge_weight.items():
        nbrs[a][b] = w
        nbrs[b][a] = w
    load = np.zeros(n_machines)
    machine_of = np.full(k, -1, dtype=np.int64)
    for a in np.argsort(-meta.vertex_weight, kind="stable"):
        affinity = np.zeros(n_machines)
        for b, w in nbrs[a].items():
            if machine_of[b] >= 0:
                affinity[machine_of[b]] += w
        # least loaded among machines, nudged by affinity
        score = load - 1e-9 * affinity
        m = int(np.argmin(score))
        machine_of[a] = m
        load[m] += meta.vertex_weight[a]
    return machine_of


def two_phase_partition(n_vertices: int, edges: np.ndarray, n_machines: int,
                        k: int | None = None,
                        vertex_weight: np.ndarray | None = None,
                        seed: int = 0,
                        cost_model=None,
                        n_candidates: int = 4,
                        w_cap: int | None = None) -> np.ndarray:
    """Returns the ``[Nv]`` machine assignment via atoms -> meta-graph ->
    LPT.

    With a fitted ``cost_model`` (``repro_torch.profile``),
    ``n_candidates`` over-partitionings (seeds ``seed .. seed +
    n_candidates - 1``) are balanced and scored by
    :func:`predicted_step_time` (the model's per-shard compute plus
    ghost rows times the measured sync cost) and the cheapest wins.
    ``cost_model=None`` is one candidate, the edge-cut objective.
    """
    if k is None:
        k = min(max(4 * n_machines, 8), n_vertices)

    def build(s):
        atom_of = over_partition(n_vertices, edges, k, vertex_weight, s)
        meta = build_meta_graph(atom_of, edges, k, vertex_weight)
        return balance_meta_graph(meta, n_machines)[atom_of]

    if cost_model is None or n_candidates <= 1:
        return build(seed)
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    degrees = (np.bincount(e[:, 0], minlength=n_vertices)
               + np.bincount(e[:, 1], minlength=n_vertices)).astype(np.int64)
    best = None
    for s in range(seed, seed + n_candidates):
        assignment = build(s)
        t = predicted_step_time(assignment, degrees, edges, n_machines,
                                cost_model, w_cap=w_cap)
        score = (np.inf if t is None else t, s)
        if best is None or score < best[0]:
            best = (score, assignment)
    return best[1]


def split_slot_weight(degrees: np.ndarray, w_cap: int) -> np.ndarray:
    """Per-vertex slot cost under hub splitting, for ``vertex_weight=``:
    the padded slots of a vertex's chunks (full chunks cost ``w_cap``,
    the remainder its covering power of two), not its raw degree."""
    deg = np.maximum(np.asarray(degrees, dtype=np.int64), 1)
    if w_cap < 2 or (w_cap & (w_cap - 1)):
        raise ValueError(
            f"w_cap={w_cap!r}: legal values are a power of two >= 2 "
            "(e.g. 2, 4, ..., 64)")
    full, rem = deg // w_cap, deg % w_cap
    # smallest power of two covering the remainder (0 -> no extra chunk)
    rem_pad = np.where(rem > 0, 2 ** np.ceil(np.log2(np.maximum(rem, 2))), 0)
    return (full * w_cap + rem_pad.astype(np.int64)).astype(np.int64)


def random_partition(n_vertices: int, n_machines: int,
                     seed: int = 0) -> np.ndarray:
    """The paper's baseline for dense bipartite graphs (Netflix, NER)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_machines, n_vertices)


def cut_edges(assignment: np.ndarray, edges: np.ndarray) -> int:
    a = np.asarray(assignment)
    e = np.asarray(edges, dtype=np.int64)
    return int((a[e[:, 0]] != a[e[:, 1]]).sum())


def ghost_rows(assignment: np.ndarray, edges: np.ndarray,
               n_machines: int) -> np.ndarray:
    """Ghost vertices per machine: distinct foreign-owned vertices
    adjacent to each machine's owned set, the rows its ghost sync
    receives every superstep."""
    a = np.asarray(assignment, dtype=np.int64)
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    # (reader machine, ghost vertex) pairs from both edge directions
    pairs = np.concatenate([
        np.stack([a[e[:, 0]], e[:, 1]], axis=1),
        np.stack([a[e[:, 1]], e[:, 0]], axis=1)])
    pairs = pairs[a[pairs[:, 1]] != pairs[:, 0]]
    if len(pairs):
        pairs = np.unique(pairs, axis=0)
    counts = np.bincount(pairs[:, 0], minlength=n_machines) \
        if len(pairs) else np.zeros(n_machines, dtype=np.int64)
    return counts.astype(np.int64)


def shard_bucket_launches(assignment: np.ndarray, degrees: np.ndarray,
                          n_machines: int,
                          w_cap: int | None = None) -> tuple:
    """The uniform per-bucket ``(width, rows)`` launch sequence a
    ``ShardPlan`` built from this assignment runs every superstep: each
    bucket at its most populated shard's row count (shards share one
    shape).  ``w_cap`` applies the hub-split chunking rule first."""
    a = np.asarray(assignment, dtype=np.int64)
    deg = np.maximum(np.asarray(degrees, dtype=np.int64), 0)
    md = max(int(deg.max()) if deg.size else 1, 1)
    if w_cap is not None and md > w_cap:
        widths = default_bucket_widths(w_cap)
    else:
        widths = default_bucket_widths(md)
        w_cap = None
    counts = np.zeros((n_machines, len(widths)), dtype=np.int64)
    for m in range(n_machines):
        dm = deg[a == m]
        if w_cap is not None:
            full, rem = dm // w_cap, dm % w_cap
            has_rem = (rem > 0) | (dm == 0)
            c = np.bincount(bucket_index(widths, rem[has_rem]),
                            minlength=len(widths))
            c[-1] += int(full.sum())
        else:
            c = np.bincount(bucket_index(widths, dm), minlength=len(widths))
        counts[m] = c
    uniform = counts.max(axis=0)
    return tuple((int(w), int(c)) for w, c in zip(widths, uniform) if c)


def predicted_step_time(assignment: np.ndarray, degrees: np.ndarray,
                        edges: np.ndarray, n_machines: int, cost_model,
                        w_cap: int | None = None) -> float | None:
    """Model-predicted distributed superstep microseconds: the cost
    model priced over the shard-uniform bucket launches, plus the
    slowest machine's ghost count times the measured per-row sync cost.
    ``None`` when the model cannot price the launch shapes."""
    launches = shard_bucket_launches(assignment, degrees, n_machines,
                                     w_cap=w_cap)
    compute = cost_model.predict_launches(launches)
    if compute is None:
        return None
    ghosts = ghost_rows(assignment, edges, n_machines)
    sync = float(getattr(cost_model, "sync_cost_us", 0.0))
    return compute + sync * float(ghosts.max() if len(ghosts) else 0)
