"""MapReduce-style (Hadoop-equivalent) baselines (paper §6.2), on the port.

The port of ``repro.baselines.mapreduce``.  The paper attributes much of
its win over Hadoop to a mechanism gap: every iteration is Map (each
edge materializes a full copy of its endpoint's data as a message) ->
Shuffle (group by destination) -> Reduce (recompute the vertex).  The
computation is the GraphLab update's; only the data movement differs,
and ``MRStats`` counts it.  Both baselines are bulk-synchronous and
non-adaptive, like their Hadoop counterparts.

The Map keeps the reference's materialization: ``[Ne, d, d]`` outer
products for ALS, ``[Ne, T]`` tables for CoEM, written to device memory.
The Shuffle is done once, at set-up: the edges are sorted by destination
with a stable numpy argsort, so each destination's messages are one
contiguous segment in edge order.  The Reduce sums each segment with the
``segment_combine`` CUDA kernel (``segment_sum_csr``), in edge order, as
the reference's ``jax.ops.segment_sum`` does on the CPU.  The per-side
solve is ``torch.linalg.solve_ex`` in full float32, as the port's ALS.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.apps.als import ALSProblem, _full_f32_matmul
from repro_torch.apps.coem import CoEMProblem
from repro_torch.kernels.segment_combine import segment_sum_csr


@dataclasses.dataclass
class MRStats:
    bytes_shuffled_per_iter: int
    messages_per_iter: int


@dataclasses.dataclass
class Shuffle:
    """One job's shuffle, fixed for the run: the edges sorted by
    destination (stable, so edge order inside a segment), the source of
    each sorted edge, and the ``[n_dst + 1]`` segment offsets."""
    order: torch.Tensor        # [Ne] int64: sorted position -> edge
    src: torch.Tensor          # [Ne] int64: source row of each sorted edge
    offsets: torch.Tensor      # [n_dst + 1] int64

    @staticmethod
    def by_destination(dst: np.ndarray, src: np.ndarray, n_dst: int,
                       device) -> "Shuffle":
        dst = np.asarray(dst, np.int64)
        order = np.argsort(dst, kind="stable")
        offsets = np.searchsorted(dst[order], np.arange(n_dst + 1))
        up = lambda a: torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.int64)).to(device)
        return Shuffle(up(order), up(np.asarray(src, np.int64)[order]),
                       up(offsets))

    def counts(self) -> torch.Tensor:
        """Messages a destination receives, as float32."""
        return (self.offsets[1:] - self.offsets[:-1]).to(torch.float32)


# ----------------------------------------------------------------------
# ALS
# ----------------------------------------------------------------------

def als_solve_side(w_src, w_dst_old, shuffle: Shuffle, ratings_sorted,
                   d: int, lam: float):
    """One MapReduce job: every rating edge emits (its source factor,
    its rating) to its destination; the reduce sums the outer products
    and the rating-weighted factors per destination and solves."""
    # Map: one message per edge, materialized (the HDFS-write analogue)
    msg_w = w_src.index_select(0, shuffle.src)                # [Ne, d]
    outer = (msg_w[:, :, None] * msg_w[:, None, :]).reshape(-1, d * d)
    # Shuffle + Reduce: contiguous segments, summed in edge order
    a = segment_sum_csr(outer, shuffle.offsets).view(-1, d, d)
    del outer
    b = segment_sum_csr((msg_w * ratings_sorted[:, None]).contiguous(),
                        shuffle.offsets)
    cnt = shuffle.counts()
    a = a + (lam * cnt.clamp_min(1.0))[:, None, None] * torch.eye(
        d, dtype=w_src.dtype, device=w_src.device)
    with _full_f32_matmul():
        w_new = torch.linalg.solve_ex(a, b[..., None]).result[..., 0]
    return torch.where(cnt[:, None] > 0, w_new, w_dst_old)


def als_jobs(problem: ALSProblem, device):
    """The two ALS jobs' shuffles (to movies, to users), each with its
    ratings in sorted order: the set-up of ``als_mapreduce_iteration``."""
    pairs = np.asarray(problem.pairs, np.int64)
    ratings = torch.from_numpy(np.asarray(problem.ratings,
                                          np.float32)).to(device)
    to_movies = Shuffle.by_destination(pairs[:, 1], pairs[:, 0],
                                       problem.n_movies, device)
    to_users = Shuffle.by_destination(pairs[:, 0], pairs[:, 1],
                                      problem.n_users, device)
    return ((to_movies, ratings.index_select(0, to_movies.order)),
            (to_users, ratings.index_select(0, to_users.order)))


def als_mapreduce_iteration(w_users, w_movies, jobs, d: int, lam: float):
    """One iteration: the movie job, then the user job.  ``jobs`` is
    ``((shuffle to movies, its sorted ratings), (shuffle to users, its
    sorted ratings))``."""
    (to_movies, r_movies), (to_users, r_users) = jobs
    w_movies = als_solve_side(w_users, w_movies, to_movies, r_movies, d, lam)
    w_users = als_solve_side(w_movies, w_users, to_users, r_users, d, lam)
    return w_users, w_movies


def als_mapreduce(problem: ALSProblem, n_iters: int, lam: float = 0.02):
    """``n_iters`` iterations of two MR jobs (movies given users, then
    users given movies): the Mahout-style Hadoop ALS iteration.  Runs on
    the problem graph's device."""
    d = problem.d
    w = problem.graph.vertex_data["w"]
    dev = w.device
    w_users, w_movies = w[: problem.n_users], w[problem.n_users:]
    jobs = als_jobs(problem, dev)
    for _ in range(n_iters):
        w_users, w_movies = als_mapreduce_iteration(w_users, w_movies, jobs,
                                                    d, lam)
    ne = len(problem.pairs)
    stats = MRStats(
        # both jobs emit one (factor + rating) message per edge
        bytes_shuffled_per_iter=2 * ne * (d + 1) * 4,
        messages_per_iter=2 * ne,
    )
    return {"w_users": w_users, "w_movies": w_movies}, stats


# ----------------------------------------------------------------------
# CoEM / NER
# ----------------------------------------------------------------------

def coem_side(src_p, shuffle: Shuffle, counts_sorted):
    """One CoEM job: every edge emits its source's table times the
    co-occurrence count; the reduce mixes and normalizes per
    destination."""
    msg = src_p.index_select(0, shuffle.src) * counts_sorted[:, None]
    num = segment_sum_csr(msg.contiguous(), shuffle.offsets)
    den = segment_sum_csr(counts_sorted[:, None].contiguous(),
                          shuffle.offsets)[:, 0]
    p = num / den.clamp_min(1e-9)[:, None]
    return p / p.sum(-1, keepdim=True).clamp_min(1e-9)


def coem_jobs(problem: CoEMProblem, device):
    """The two CoEM jobs' shuffles (to contexts, to phrases), each with
    its co-occurrence counts in sorted order."""
    n_p = problem.n_phrases
    g = problem.graph
    phr, ctx = g.edges_np[:, 0], g.edges_np[:, 1] - n_p
    counts = g.edge_data["count"][:-1].to(device, torch.float32)
    to_ctx = Shuffle.by_destination(ctx, phr, problem.n_contexts, device)
    to_phr = Shuffle.by_destination(phr, ctx, n_p, device)
    return ((to_ctx, counts.index_select(0, to_ctx.order)),
            (to_phr, counts.index_select(0, to_phr.order)))


def coem_mapreduce_iteration(p_phr, jobs, seeds, p_phr0):
    """One iteration: contexts from phrases, then phrases from contexts
    (seed phrases keep ``p_phr0``).  ``jobs`` is ``((shuffle to contexts,
    its sorted counts), (shuffle to phrases, its sorted counts))``;
    returns ``(p_phr, p_ctx)``."""
    (to_ctx, c_ctx), (to_phr, c_phr) = jobs
    p_ctx = coem_side(p_phr, to_ctx, c_ctx)
    p_phr = torch.where(seeds[:, None], p_phr0,
                        coem_side(p_ctx, to_phr, c_phr))
    return p_phr, p_ctx


def coem_mapreduce(problem: CoEMProblem, n_iters: int):
    """``n_iters`` iterations of the two CoEM jobs (contexts given
    phrases, then phrases given contexts; seed phrases keep their
    tables), on the problem graph's device."""
    n_p = problem.n_phrases
    g = problem.graph
    p0 = g.vertex_data["p"]
    dev = p0.device
    seeds = g.vertex_data["is_seed"][:n_p] > 0
    p_phr, p_ctx = p0[:n_p], p0[n_p:]
    p_phr0 = p_phr
    jobs = coem_jobs(problem, dev)
    for _ in range(n_iters):
        p_phr, p_ctx = coem_mapreduce_iteration(p_phr, jobs, seeds, p_phr0)
    ne = g.n_edges
    t = p0.shape[1]
    stats = MRStats(
        bytes_shuffled_per_iter=2 * ne * t * 4,  # probability table per edge
        messages_per_iter=2 * ne,
    )
    return {"p": torch.cat([p_phr, p_ctx], dim=0)}, stats
