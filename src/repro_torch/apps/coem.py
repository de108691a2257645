"""CoEM for Named Entity Recognition (paper §5.3), on the port.

The port of ``repro.apps.coem``.  Bipartite data graph: noun-phrase
vertices on the left, context vertices on the right, an edge where a
phrase occurs in a context with the co-occurrence count as edge data.
Vertex data is the estimated distribution over entity types; the update
takes the count-weighted mix of the neighbours' tables and normalizes,
and seed phrases keep their labels.  The mix is declared as a
``NeighborAggregator`` at F = ``n_types``, so the engine runs it through
the ``ell_spmv`` CUDA kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.coloring import bipartite_coloring
from repro_torch.core.graph import DataGraph, bipartite_edges
from repro_torch.core.sync import SyncOp
from repro_torch.core.update import (Consistency, ScopeBatch, UpdateFn,
                                     UpdateResult, aggregator_update,
                                     slot_fold_sum)


def make_update(eps: float = 1e-3) -> UpdateFn:
    """The CoEM update: the weighted mix through the kernel, then the
    normalization and the seed clamp in ``combine``."""

    def feature(vertex_data):
        return vertex_data["p"]                      # [..., T]

    def weight(scope: ScopeBatch):
        return scope.edge_data["count"]              # [B, D]

    def combine(scope: ScopeBatch, mix) -> UpdateResult:
        w = torch.where(scope.nbr_mask, scope.edge_data["count"], 0.0).float()
        denom = slot_fold_sum(w).clamp(min=1e-9)[:, None]
        new_p = mix / denom
        new_p = new_p / new_p.sum(-1, keepdim=True).clamp(min=1e-9)
        # seeds are clamped to their prior label
        seed = scope.v_data["is_seed"][:, None] > 0
        new_p = torch.where(seed, scope.v_data["p"], new_p)
        delta = torch.abs(new_p - scope.v_data["p"]).sum(dim=1)
        changed = delta > eps
        return UpdateResult(
            v_data={"p": new_p, "is_seed": scope.v_data["is_seed"]},
            resched_nbrs=changed[:, None].expand(scope.nbr_mask.shape),
            priority=delta,
        )

    return aggregator_update(feature, weight, combine, Consistency.EDGE,
                             name="coem")


def entropy_sync(tau: int = 1) -> SyncOp:
    """Global mean label entropy — a convergence estimator sync."""
    def fold(acc, row):
        p = row["p"].clamp(1e-9, 1.0)
        h = -(p * torch.log(p)).sum()
        return (acc[0] + h, acc[1] + 1.0)
    return SyncOp(
        key="entropy", fold=fold,
        merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
        finalize=lambda acc: acc[0] / acc[1].clamp(min=1.0),
        acc0=(torch.tensor(0.0), torch.tensor(0.0)), tau=tau)


@dataclasses.dataclass
class CoEMProblem:
    graph: DataGraph
    n_phrases: int
    n_contexts: int
    n_types: int
    true_types: np.ndarray


def synthetic_ner(n_phrases: int, n_contexts: int, n_types: int,
                  mean_deg: int = 6, seed_frac: float = 0.05,
                  seed: int = 0, device=None) -> CoEMProblem:
    """Planted-types corpus: each phrase/context has a latent type; edges
    prefer same-type pairs, so CoEM can propagate seed labels.  The
    reference's generator draw for draw, so a seed gives its corpus."""
    rng = np.random.default_rng(seed)
    pt = rng.integers(0, n_types, n_phrases)
    ct = rng.integers(0, n_types, n_contexts)
    pairs = []
    counts = []
    for i in range(n_phrases):
        k = max(1, rng.poisson(mean_deg))
        same = np.nonzero(ct == pt[i])[0]
        for _ in range(k):
            if len(same) and rng.random() < 0.85:
                j = int(rng.choice(same))
            else:
                j = int(rng.integers(0, n_contexts))
            pairs.append((i, j))
            counts.append(float(rng.integers(1, 5)))
    pairs = np.asarray(pairs, dtype=np.int64)
    # dedupe
    _, keep = np.unique(pairs[:, 0] * n_contexts + pairs[:, 1],
                        return_index=True)
    pairs, counts = pairs[keep], np.asarray(counts, np.float32)[keep]
    n_seed = max(n_types, int(seed_frac * n_phrases))
    seeds = rng.choice(n_phrases, size=n_seed, replace=False)
    return problem_from_pairs(pairs, counts, pt, ct, n_types, seeds,
                              device=device)


def problem_from_pairs(pairs: np.ndarray, counts: np.ndarray,
                       phrase_types: np.ndarray, context_types: np.ndarray,
                       n_types: int, seeds: np.ndarray,
                       device=None) -> CoEMProblem:
    """A colored CoEM problem from deduplicated ``(phrase, context)``
    pairs with their counts, the planted types and the seed phrases
    (uniform tables, seeds one-hot on their type)."""
    n_phrases, n_contexts = len(phrase_types), len(context_types)
    nv, edges = bipartite_edges(n_phrases, n_contexts, pairs)
    p0 = np.full((nv, n_types), 1.0 / n_types, np.float32)
    is_seed = np.zeros(nv, np.float32)
    p0[seeds] = 0.0
    p0[seeds, phrase_types[seeds]] = 1.0
    is_seed[seeds] = 1.0
    g = DataGraph.from_edges(
        nv, edges,
        vertex_data={"p": p0, "is_seed": is_seed},
        edge_data={"count": np.asarray(counts, np.float32)}, device=device)
    g = g.with_colors(bipartite_coloring(n_phrases, nv))
    return CoEMProblem(g, n_phrases, n_contexts, n_types,
                       np.concatenate([phrase_types, context_types]))


def build(problem: CoEMProblem, *, eps: float = 1e-3, tau: int = 1):
    """Uniform facade triple ``(graph, update, syncs)`` for a problem
    from ``synthetic_ner``."""
    return problem.graph, make_update(eps), (entropy_sync(tau),)


def label_accuracy(problem: CoEMProblem, vertex_data) -> float:
    pred = vertex_data["p"].cpu().numpy().argmax(axis=1)
    return float((pred == problem.true_types).mean())
