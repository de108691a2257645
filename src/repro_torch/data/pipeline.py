"""Live-graph mutation traffic for online serving (DESIGN.md §13).

The port of ``MutationBatch`` and ``edge_stream`` from
``repro.data.pipeline`` (the language-model token pipelines there are
not ported).  Both are host numpy on the same seeded ``default_rng``
calls, so a stream is bitwise the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class MutationBatch(NamedTuple):
    """One timestamped batch of live-graph mutation traffic (DESIGN.md
    §13): ``edges`` to insert plus ``touch`` — vertex ids whose data the
    driver should rewrite (the app decides the payload).  ``queries`` are
    vertex ids to read back between recompute rounds."""
    t: int
    edges: np.ndarray            # [k, 2] int64, deduped, no self-loops
    touch: np.ndarray            # [m] int64 vertex ids for data updates
    queries: np.ndarray          # [q] int64 vertex ids to read


def edge_stream(n_vertices: int, rate: float = 8.0, seed: int = 0,
                n_batches: int = 16, alpha: float = 2.0,
                update_frac: float = 0.5, query_rate: float = 4.0):
    """Deterministic stream of ``MutationBatch``es for online serving.

    Per batch ``t``: ``k ~ Poisson(rate)`` candidate edge inserts with
    Zipf(``alpha``)-skewed endpoints (hot vertices keep getting hotter,
    matching the power-law graphs the paper's workloads use), deduped and
    self-loop-free; ``~update_frac * k`` vertex-data touches drawn from
    the same skew; ``~Poisson(query_rate)`` uniform read queries.  Same
    ``(n_vertices, rate, seed, ...)`` -> bitwise-identical stream, so
    traces are replayable across the incremental and rebuild paths.
    """
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, n_vertices + 1, dtype=np.float64) ** alpha
    weights /= weights.sum()
    # ``rng.choice(n, p=weights)`` draws one uniform and searches the
    # normalized cumulative weights; doing exactly that with the
    # cumulative weights built once (not once a draw) gives the same
    # stream at O(log n) a draw instead of O(n)
    cdf = weights.cumsum()
    cdf /= cdf[-1]

    def choice(size):
        return cdf.searchsorted(rng.random(size), side="right")

    for t in range(n_batches):
        k = int(rng.poisson(rate))
        uv = choice(2 * k).reshape(k, 2).tolist()
        pairs: list[tuple[int, int]] = []
        seen: set[tuple[int, int]] = set()
        for u, v in uv:
            if u == v:
                continue
            key = (min(u, v), max(u, v))
            if key in seen:
                continue
            seen.add(key)
            pairs.append(key)
        edges = (np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
                 if pairs else np.zeros((0, 2), np.int64))
        m = int(round(update_frac * len(pairs)))
        touch = (choice(m).astype(np.int64) if m
                 else np.zeros(0, np.int64))
        q = int(rng.poisson(query_rate))
        queries = (rng.integers(0, n_vertices, size=q).astype(np.int64)
                   if q else np.zeros(0, np.int64))
        yield MutationBatch(t=t, edges=edges, touch=np.unique(touch),
                            queries=queries)
