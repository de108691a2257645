"""Bayesian Probabilistic Tensor Factorization (paper §5.4), on the port.

The port of ``repro.apps.bptf``.  The tensor R ~ V (x) U (x) T is a
tripartite data graph: users, movies and time factors; each rating edge
joins a user and a movie and carries its time index, and the time
vertices chain to their neighbours (temporal smoothing).  The update is
the MAP/ALS variant of BPTF: the conditional least-squares solve of one
factor given the elementwise product of the other two, whose time factor
comes from a global ``[T, d]`` table that a sync keeps.

The deg-bound half of the update, the normal equations ``(A, b)`` over
the design rows ``X = nbr_w * time_table[tid]``, goes through the
``als_normal_eq`` CUDA kernel (``als_normal_eq_fold``), as the port's
ALS does; the reference computes the same function with two einsums.
The ridge, the LU solve and the smoothing stay PyTorch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.apps.als import MASK_BLOCK_DOUBLES, _full_f32_matmul, \
    _rating_pairs
from repro_torch.core.coloring import greedy_coloring
from repro_torch.core.graph import DataGraph
from repro_torch.core.sync import SyncOp
from repro_torch.core.update import (Consistency, ScopeBatch, UpdateFn,
                                     UpdateResult)
from repro_torch.kernels.als_normal_eq import als_normal_eq_fold


def make_update(d: int, lam: float = 0.05, eps: float = 1e-3) -> UpdateFn:
    """Vertex kinds: 0 = user, 1 = movie, 2 = time.  For a rating (u, m,
    t), r ~ <w_u * w_m, w_t>.  A user or movie solves its ridge problem
    with design rows ``nbr_w * w_time``; a time vertex smooths toward its
    neighbouring time factors."""
    def update(scope: ScopeBatch) -> UpdateResult:
        kind = scope.v_data["kind"]                    # [B]
        w = scope.v_data["w"]                          # [B, d]
        nbr_w = scope.nbr_data["w"]                    # [B, D, d]
        nbr_kind = scope.nbr_data["kind"]              # [B, D]
        r = scope.edge_data["rating"]                  # [B, D]
        tid = scope.edge_data["time"].long()           # [B, D]
        time_table = scope.globals["time_factors"]     # [T, d]
        mask = scope.nbr_mask
        X = nbr_w * time_table[tid]                    # [B, D, d]
        # normal equations: A = sum m X X^T, b = sum m r X
        A, b = als_normal_eq_fold(mask, r.contiguous(), X)
        n_obs = mask.to(w.dtype).sum(dim=1)
        A = A + (lam * n_obs.clamp_min(1.0))[:, None, None] * torch.eye(
            d, dtype=w.dtype, device=w.device)
        with _full_f32_matmul():
            # the ridge makes A positive definite: no error check (a sync)
            w_ls = torch.linalg.solve_ex(A, b[..., None]).result[..., 0]
        # time vertices: smooth toward neighbouring time factors
        is_time = nbr_kind == 2
        nbr_time = torch.where(is_time[..., None], nbr_w, 0.0)
        n_time = (mask & is_time).sum(dim=1).clamp_min(1)
        w_smooth = (w + nbr_time.sum(dim=1)) / (1.0 + n_time)[:, None]
        new_w = torch.where((kind == 2)[:, None], w_smooth,
                            torch.where(n_obs[:, None] > 0, w_ls, w))
        delta = (new_w - w).abs().amax(dim=1)
        return UpdateResult(
            v_data={"w": new_w, "kind": kind, "tslot": scope.v_data["tslot"]},
            resched_nbrs=(delta > eps)[:, None].expand(mask.shape),
            priority=delta,
        )
    return UpdateFn(update, Consistency.EDGE, name="bptf")


def time_table_sync(n_times: int, d: int, tau: int = 1) -> SyncOp:
    """The global ``[T, d]`` time-factor table, the mean of the time
    vertices' factors in each slot.  The fold adds a vertex's factor to
    its slot through a one-hot product (out of place, as ``vmap``
    needs): the other slots add ``0 * w``, which leaves them as they
    were, so the table is bitwise the reference's ``.at[slot].add``."""
    def fold(acc, row):
        tab, cnt = acc
        is_time = (row["kind"] == 2).to(tab.dtype)
        slot = row["tslot"].to(torch.int64).clamp(0, n_times - 1)
        hot = (torch.arange(n_times, device=tab.device) == slot).to(
            tab.dtype)
        tab = tab + hot[:, None] * (is_time * row["w"])[None, :]
        cnt = cnt + hot * is_time
        return (tab, cnt)
    return SyncOp(
        key="time_factors", fold=fold,
        merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
        finalize=lambda acc: acc[0] / acc[1].clamp_min(1.0)[:, None],
        acc0=(torch.zeros((n_times, d), dtype=torch.float32),
              torch.zeros((n_times,), dtype=torch.float32)),
        tau=tau)


@dataclasses.dataclass
class BPTFProblem:
    graph: DataGraph
    n_users: int
    n_movies: int
    n_times: int
    d: int
    ratings: np.ndarray
    triples: np.ndarray     # [Ne, 3] (user, movie, time)
    noise: float


def tripartite_coloring(n_users: int, n_movies: int,
                        n_times: int) -> np.ndarray:
    """A 2-coloring of the BPTF graph: users 0, movies 1, the time chain
    alternating (rating edges join users to movies only)."""
    return np.concatenate([
        np.zeros(n_users, np.int32), np.ones(n_movies, np.int32),
        np.arange(n_times, dtype=np.int32) % 2])


def synthetic_bptf(n_users: int, n_movies: int, n_times: int, d: int,
                   density: float, noise: float = 0.05, seed: int = 0,
                   device=None) -> BPTFProblem:
    """Low-rank ground truth r = <u * t, v> + noise: the reference's
    ``default_rng(seed)`` draws in the reference's order, so a seed gives
    its problem.  The rating mask is drawn in blocks of user rows (the
    same values as one draw, see ``als._rating_pairs``), so the host never
    holds the dense ``[n_users, n_movies]`` mask.  The graph is colored
    greedily, as the reference's."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, d)) / d ** 0.5
    V = rng.normal(size=(n_movies, d)) / d ** 0.5
    T = 1.0 + 0.1 * rng.normal(size=(n_times, d))
    block_rows = max(1, MASK_BLOCK_DOUBLES // max(n_movies, 1))
    ui, mi = _rating_pairs(rng, n_users, n_movies, density, block_rows)
    ti = rng.integers(0, n_times, len(ui))
    ratings = (np.einsum("ed,ed->e", U[ui] * T[ti], V[mi])
               + noise * rng.normal(size=len(ui))).astype(np.float32)
    w0 = rng.normal(size=(n_users + n_movies + n_times, d)).astype(
        np.float32) * 0.1
    return problem_from_triples(n_users, n_movies, n_times, d, ui, mi, ti,
                                ratings, w0, noise, device=device)


def problem_from_triples(n_users: int, n_movies: int, n_times: int, d: int,
                         ui: np.ndarray, mi: np.ndarray, ti: np.ndarray,
                         ratings: np.ndarray, w0: np.ndarray,
                         noise: float = 0.0,
                         colors: np.ndarray | None = None,
                         device=None) -> BPTFProblem:
    """The tripartite graph of rating triples ``(ui, mi, ti)``: one edge a
    rating (user -> movie, with its rating and time as edge data) in
    triple order, then the time chain; initial factors ``w0`` with the
    time factors set to 1 (multiplicative).  Colored greedily, as the
    reference's, unless ``colors`` gives a coloring (a bulk problem
    takes ``tripartite_coloring``: greedy coloring loops in Python)."""
    nu, nm, nt = n_users, n_movies, n_times
    ne = len(ui)
    chain = np.arange(nt - 1, dtype=np.int64) + nu + nm
    edges = np.concatenate([
        np.stack([np.asarray(ui, np.int64), np.asarray(mi, np.int64) + nu],
                 axis=1),
        np.stack([chain, chain + 1], axis=1)]).reshape(-1, 2)
    n_chain = max(nt - 1, 0)
    rating_data = np.concatenate([np.asarray(ratings, np.float32),
                                  np.zeros(n_chain, np.float32)])
    time_data = np.concatenate([np.asarray(ti).astype(np.float32),
                                np.zeros(n_chain, np.float32)])
    nv = nu + nm + nt
    kind = np.zeros(nv, np.float32)
    kind[nu:nu + nm] = 1
    kind[nu + nm:] = 2
    tslot = np.zeros(nv, np.float32)
    tslot[nu + nm:] = np.arange(nt)
    w0 = np.array(w0, np.float32)
    w0[nu + nm:] = 1.0
    g = DataGraph.from_edges(
        nv, edges, vertex_data={"w": w0, "kind": kind, "tslot": tslot},
        edge_data={"rating": rating_data, "time": time_data}, device=device)
    g = g.with_colors(greedy_coloring(nv, edges) if colors is None
                      else colors)
    return BPTFProblem(g, nu, nm, nt, d, np.asarray(ratings, np.float32),
                       np.stack([ui, mi, ti], 1)[:ne], noise)


def build(problem: BPTFProblem, *, lam: float = 0.05, eps: float = 1e-3,
          tau: int = 1):
    """Uniform facade triple ``(graph, update, syncs)`` for a problem
    from ``synthetic_bptf`` (the time-table sync is load-bearing: the
    update reads the global time factors from ``scope.globals``)."""
    return (problem.graph, make_update(problem.d, lam=lam, eps=eps),
            (time_table_sync(problem.n_times, problem.d, tau),))


def dataset_rmse(problem: BPTFProblem, vertex_data, globals_) -> float:
    """RMSE of the ratings' predictions ``<w_u * t, w_m>``, in float32
    numpy as the reference's."""
    host = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    w = host(vertex_data["w"])
    tt = host(globals_["time_factors"])
    u = w[problem.triples[:, 0]]
    v = w[problem.triples[:, 1] + problem.n_users]
    t = tt[problem.triples[:, 2]]
    pred = np.einsum("ed,ed->e", u * t, v)
    return float(np.sqrt(np.mean((pred - problem.ratings) ** 2)))
