"""Alternating Least Squares collaborative filtering (paper §5.1, Netflix),
on the port.

Bipartite data graph: users [0, n_users) and movies [n_users, n_users +
n_movies); an edge per observed rating.  Vertex data holds the latent
factor row ``w`` (dim d) plus the squared prediction error and rating
count that the RMSE sync aggregates.  The update solves the regularized
least-squares problem of a vertex from its neighbours' factors — the
paper's O(d^3 + deg) update — and reschedules its neighbours when its
factor moved more than ``eps`` (adaptive ALS; ``eps=0`` sweeps every
vertex every superstep).  The bipartite graph is two-colored, so it runs
on the chromatic engine.

The deg-bound half of the update, the normal equations ``(A, b)``, goes
through the ``als_normal_eq`` CUDA kernel (``als_normal_eq_fold`` on the
gathered scope).  The reference computes that same function with two
einsums; the ridge, the LU solve and the prediction stay PyTorch
(``ridge_solve``), as the reference leaves them outside any kernel.
Both halves are looked up as this module's attributes when the update
runs, so an instrument that wraps them here sees every call.

Inside a ``repro_torch.profile.tracing()`` context the update records a
``kernel`` span (attribute ``kernel="als_normal_eq"``) around the fold,
a ``solve`` span around ``ridge_solve`` and the counter
``als.fold_slots``: the ``B x D`` slots each fold reads (``slots.real``
over it is the fold's useful share).

``from_ratings`` builds a problem from given ``(user, movie, rating)``
triples; ``synthetic_netflix`` draws its triples and builds through it.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.core.coloring import bipartite_coloring
from repro_torch.core.graph import DataGraph, bipartite_edges
from repro_torch.core.sync import SyncOp
from repro_torch.core.update import (Consistency, ScopeBatch, UpdateFn,
                                     UpdateResult)
from repro_torch.kernels.als_normal_eq import als_normal_eq_fold
from repro_torch.profile.trace import count, span


@contextlib.contextmanager
def _full_f32_matmul():
    """cuBLAS and cuSOLVER in full float32 (no TF32) inside the block,
    whatever the caller set: ALS's factors are held to float64 solves."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def ridge_solve(A: torch.Tensor, b: torch.Tensor, n_obs: torch.Tensor,
                w_old: torch.Tensor, X: torch.Tensor, lam: float):
    """The vertex half of the update after the fold: the ridge
    ``lam * max(n_obs, 1)`` on A's diagonal (ALS-WR), the LU solve of
    ``A w = b``, isolated vertices (``n_obs == 0``) keeping ``w_old``,
    and the prediction ``<w, X_j>`` of every slot.  Returns ``(w_new
    [B, d], pred [B, D])``."""
    d = A.shape[-1]
    A = A + (lam * n_obs.clamp_min(1.0))[:, None, None] * torch.eye(
        d, dtype=A.dtype, device=A.device)
    with _full_f32_matmul():
        # LU as jnp.linalg.solve; solve_ex leaves the error check (a
        # host sync) out: the ridge makes A positive definite
        w_new = torch.linalg.solve_ex(A, b[..., None]).result[..., 0]
        # isolated vertices keep their factor
        w_new = torch.where(n_obs[:, None] > 0, w_new, w_old)
        # local residual (for the RMSE sync); counted on movie side only
        pred = torch.einsum("bi,bdi->bd", w_new, X)
    return w_new, pred


def make_update(d: int, lam: float = 0.05, eps: float = 1e-3) -> UpdateFn:
    def update(scope: ScopeBatch) -> UpdateResult:
        X = scope.nbr_data["w"]                      # [B, D, d]
        r = scope.edge_data["rating"]                # [B, D]
        mask = scope.nbr_mask
        m = mask.to(X.dtype)
        # normal equations: (X^T X + lam*n*I) w = X^T r
        count("als.fold_slots", mask.numel())
        with span("kernel", kernel="als_normal_eq"):
            A, b = als_normal_eq_fold(mask, r, X)
        n_obs = m.sum(dim=1)
        with span("solve"):
            w_new, pred = ridge_solve(A, b, n_obs, scope.v_data["w"], X, lam)
        se = ((pred - r) * m).square().sum(dim=1)
        is_right = scope.v_data["is_movie"]
        delta = (w_new - scope.v_data["w"]).abs().amax(dim=1)
        changed = delta > eps
        return UpdateResult(
            v_data={
                "w": w_new,
                "err": torch.where(is_right > 0, se, 0.0),
                "cnt": torch.where(is_right > 0, n_obs, 0.0),
                "is_movie": is_right,
            },
            resched_nbrs=changed[:, None].expand(mask.shape),
            priority=delta,
        )
    return UpdateFn(update, Consistency.EDGE, name="als")


def rmse_sync(tau: int = 1) -> SyncOp:
    """Global RMSE over observed ratings, from per-movie residuals."""
    return SyncOp(
        key="rmse",
        fold=lambda acc, row: (acc[0] + row["err"], acc[1] + row["cnt"]),
        merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
        finalize=lambda acc: torch.sqrt(acc[0] / acc[1].clamp_min(1.0)),
        acc0=(torch.tensor(0.0), torch.tensor(0.0)),
        tau=tau,
    )


# doubles of the rating mask drawn at a time (about 128 MB)
MASK_BLOCK_DOUBLES = 1 << 24


@dataclasses.dataclass
class ALSProblem:
    graph: DataGraph
    n_users: int
    n_movies: int
    d: int
    ratings: np.ndarray     # [Ne]
    pairs: np.ndarray       # [Ne, 2] (user, movie) indices
    noise: float


def _rating_pairs(rng, n_users: int, n_movies: int, density: float,
                  block_rows: int):
    """``np.nonzero(rng.random((n_users, n_movies)) < density)``, drawn
    ``block_rows`` user rows at a time.  PCG64's ``random()`` spends one
    64-bit draw per double, so blocks drawn in sequence give the same
    values and leave the generator in the same state as one draw, while
    the host never holds more than one block (the whole mask is
    ``n_users * n_movies`` doubles: 6.8 GB at 48,019 x 17,770)."""
    ui, mi = [], []
    for r0 in range(0, n_users, block_rows):
        rows = min(block_rows, n_users - r0)
        u, m = np.nonzero(rng.random((rows, n_movies)) < density)
        ui.append(u + r0)
        mi.append(m)
    if not ui:
        return np.zeros(0, np.intp), np.zeros(0, np.intp)
    return np.concatenate(ui), np.concatenate(mi)


def synthetic_netflix(n_users: int, n_movies: int, d: int, density: float,
                      noise: float = 0.1, seed: int = 0,
                      d_model: int | None = None, slack: int = 0,
                      device=None) -> ALSProblem:
    """Low-rank ground-truth ratings r = <u, v> + noise.

    The same ``default_rng(seed)`` stream as the reference's
    ``synthetic_netflix``, so the problem is array for array the
    reference's.  ``d_model`` is the factor dimension used by the solver
    (defaults to the generative d); ``slack=`` reserves mutable storage
    for new ratings arriving through ``api.serve``.  The graph's tensors
    go to ``device`` (default: the GPU).
    """
    rng = np.random.default_rng(seed)
    d_model = d_model or d
    U = rng.normal(size=(n_users, d)) / np.sqrt(d)
    V = rng.normal(size=(n_movies, d)) / np.sqrt(d)
    block_rows = max(1, MASK_BLOCK_DOUBLES // max(n_movies, 1))
    ui, mi = _rating_pairs(rng, n_users, n_movies, density, block_rows)
    ratings = (np.einsum("ed,ed->e", U[ui], V[mi])
               + noise * rng.normal(size=len(ui))).astype(np.float32)
    pairs = np.stack([ui, mi], axis=1)
    w0 = rng.normal(size=(n_users + n_movies, d_model)).astype(
        np.float32) * 0.1
    problem = from_ratings(n_users, n_movies, pairs, ratings, d_model, w0,
                           slack=slack, device=device)
    return dataclasses.replace(problem, noise=noise)


def from_ratings(n_users: int, n_movies: int, pairs, ratings, d: int, w0,
                 *, slack: int = 0, device=None) -> ALSProblem:
    """The problem of given ratings: ``pairs [Ne, 2]`` (user, movie)
    indices, one rating each (``ratings [Ne]`` float32), and the
    starting factors ``w0 [n_users + n_movies, d]`` (users first).  The
    graph is the bipartite rating graph, two-colored (users 0, movies
    1), with ``slack=`` free slots a row for ``api.serve``; its tensors
    go to ``device`` (default: the GPU).  ``noise`` is 0: the ratings'
    noise is unknown here."""
    pairs = np.asarray(pairs)
    ratings = np.asarray(ratings, np.float32)
    nv, edges = bipartite_edges(n_users, n_movies, pairs)
    if ratings.shape != (len(edges),):
        raise ValueError(f"ratings must be [{len(edges)}], one a pair, "
                         f"got {ratings.shape}")
    if tuple(np.shape(w0)) != (nv, d):
        raise ValueError(f"w0 must be [{nv}, {d}], got {np.shape(w0)}")
    is_movie = np.zeros(nv, np.float32)
    is_movie[n_users:] = 1.0
    g = DataGraph.from_edges(
        nv, edges,
        vertex_data={
            "w": w0,
            "err": np.zeros(nv, np.float32),
            "cnt": np.zeros(nv, np.float32),
            "is_movie": is_movie,
        },
        edge_data={"rating": ratings},
        slack=slack,
        device=device,
    )
    g = g.with_colors(bipartite_coloring(n_users, nv))
    return ALSProblem(g, n_users, n_movies, d, ratings, pairs, 0.0)


def build(problem: ALSProblem, *, lam: float = 0.05, eps: float = 1e-3,
          tau: int = 1):
    """Uniform facade triple ``(graph, update, syncs)`` for a problem
    from ``synthetic_netflix`` or ``from_ratings`` (keep the problem
    around for ``dataset_rmse``)."""
    return (problem.graph, make_update(problem.d, lam=lam, eps=eps),
            (rmse_sync(tau),))


def dataset_rmse(problem: ALSProblem, vertex_data) -> float:
    """Exact test-style RMSE from factors (oracle for the sync op), in
    the reference's float32 numpy arithmetic."""
    w = vertex_data["w"]
    w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
    u = w[problem.pairs[:, 0]]
    v = w[problem.pairs[:, 1] + problem.n_users]
    pred = np.einsum("ed,ed->e", u, v)
    return float(np.sqrt(np.mean((pred - problem.ratings) ** 2)))
