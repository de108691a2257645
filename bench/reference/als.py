"""ALS sweeps over rating triples, in float64, and the same sweeps in a
lower precision.

The paper's ALS (GraphLab §5.1) with the ALS-WR ridge: a sweep solves
every user ``(sum_j v_j v_j^T + lam n I) u = sum_j r_j v_j`` over its
``n`` ratings from the movies' current factors, then every movie the
same way from the users' new ones; a vertex with no rating keeps its
factor (``max(n, 1)`` in the ridge, as the port's).  ``sweeps`` replays
that from ``w0`` in float64, a block of rows and a chunk of ratings at a
time, so it needs a few GB beside the triples; ``sweeps(...,
lowp=True)`` is the control, the same sweeps with factors and ratings
held in bfloat16 and the sums, the ridge and the solve in float32.
``rmse`` is the training RMSE of a set of factors.

Departures from the published description: the ratings are triples the
caller gives (the benchmark's planted model, not Netflix's stars); the
sweep count is fixed by the caller, not a convergence test; the solve is
LU (``torch.linalg.solve``), as the port's, not a Cholesky.
"""
from __future__ import annotations

import numpy as np
import torch

ROW_BLOCK = 1 << 16          # rows solved at a time
EDGE_CHUNK = 1 << 20         # outer products formed at a time


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Triples:
    """The ratings on ``device``, each side's rows sorted for its half
    sweep: ``side(0)`` gives the users' ``(rows, cols, ratings, offsets)``
    with ``cols`` the movies' ids after the users, ``side(1)`` the
    movies'."""

    def __init__(self, n_users, n_movies, users, movies, ratings, device):
        self.n_users, self.n_movies = n_users, n_movies
        u = torch.as_tensor(np.asarray(users), device=device).long()
        m = torch.as_tensor(np.asarray(movies), device=device).long()
        self.r = torch.as_tensor(np.asarray(ratings, np.float32),
                                 device=device)
        self.u, self.m = u, m + n_users
        self.device = device

    def side(self, s):
        rows, cols = (self.u, self.m) if s == 0 else (self.m, self.u)
        order = torch.sort(rows, stable=True).indices
        lo = 0 if s == 0 else self.n_users
        n = self.n_users if s == 0 else self.n_movies
        counts = torch.bincount(rows - lo, minlength=n)
        offsets = torch.zeros(n + 1, dtype=torch.int64, device=self.device)
        offsets[1:] = torch.cumsum(counts, 0)
        return lo, n, rows[order] - lo, cols[order], self.r[order], offsets


def _half_sweep(w, side, lam, lowp):
    """Solve every row of ``side`` from ``w``'s other rows; returns the
    new ``w``."""
    lo, n, rows, cols, r, offsets = side
    d = w.shape[1]
    acc = torch.float32 if lowp else torch.float64
    x_all = w.to(torch.bfloat16).to(acc) if lowp else w.to(acc)
    r_all = r.to(torch.bfloat16).to(acc) if lowp else r.to(acc)
    eye = torch.eye(d, dtype=acc, device=w.device)
    out = w.clone()
    off = offsets.tolist()
    for r0 in range(0, n, ROW_BLOCK):
        r1 = min(n, r0 + ROW_BLOCK)
        A = torch.zeros((r1 - r0, d, d), dtype=acc, device=w.device)
        b = torch.zeros((r1 - r0, d), dtype=acc, device=w.device)
        for e0 in range(off[r0], off[r1], EDGE_CHUNK):
            e1 = min(off[r1], e0 + EDGE_CHUNK)
            x = x_all[cols[e0:e1]]
            loc = rows[e0:e1] - r0
            A.index_add_(0, loc, x[:, :, None] * x[:, None, :])
            b.index_add_(0, loc, x * r_all[e0:e1, None])
        cnt = (offsets[r0 + 1: r1 + 1] - offsets[r0:r1]).to(acc)
        A += (lam * cnt.clamp_min(1.0))[:, None, None] * eye
        new = torch.linalg.solve(A, b[..., None])[..., 0]
        keep = out[lo + r0: lo + r1]
        new = torch.where(cnt[:, None] > 0, new.to(out.dtype), keep)
        if lowp:
            new = new.to(torch.bfloat16).to(out.dtype)
        out[lo + r0: lo + r1] = new
    return out


def sweeps(triples: Triples, w0, lam: float, n_sweeps: int,
           lowp: bool = False):
    """``[n_users + n_movies, d]`` factors after ``n_sweeps`` sweeps from
    ``w0``: float64, or with ``lowp`` the control's bfloat16 factors
    (returned as float32)."""
    _no_tf32()
    dtype = torch.float32 if lowp else torch.float64
    w = torch.as_tensor(np.asarray(w0), device=triples.device).to(dtype)
    if lowp:
        w = w.to(torch.bfloat16).to(dtype)
    sides = (triples.side(0), triples.side(1))
    for _ in range(n_sweeps):
        for side in sides:
            w = _half_sweep(w, side, lam, lowp)
    return w


def rmse(triples: Triples, w, lowp: bool = False) -> float:
    """The RMSE of ``w``'s predictions over every rating: float64, or
    with ``lowp`` bfloat16 factors and ratings summed in float32."""
    acc = torch.float32 if lowp else torch.float64
    w = torch.as_tensor(w, device=triples.device)
    w = w.to(torch.bfloat16).to(acc) if lowp else w.to(acc)
    r = triples.r.to(torch.bfloat16).to(acc) if lowp else triples.r.to(acc)
    se = torch.zeros((), dtype=acc, device=triples.device)
    for e0 in range(0, r.shape[0], EDGE_CHUNK):
        e1 = e0 + EDGE_CHUNK
        pred = (w[triples.u[e0:e1]] * w[triples.m[e0:e1]]).sum(1)
        se += (pred - r[e0:e1]).square().sum()
    return float(torch.sqrt(se / max(r.shape[0], 1)))


def compare(triples: Triples, ref_w, ref_rmse: float, w, sync_rmse: float,
            updates_short: int) -> dict:
    """The numbers one answer is judged by: each vertex's normwise
    relative gap of its factor from the float64 replay (the worst and
    the mean), the RMSE sync against the float64 RMSE of the answer's own
    factors, that RMSE against the replay's (both relative), and the
    updates the job left out of its sweeps."""
    w = torch.as_tensor(np.asarray(w), device=triples.device).double()
    if w.shape != ref_w.shape or not bool(torch.isfinite(w).all()):
        inf = float("inf")
        return {"factor_gap_max": inf, "factor_gap_mean": inf,
                "rmse_gap": inf, "rmse_ref_gap": inf,
                "updates_short": float(updates_short)}
    gap = ((w - ref_w).norm(dim=1)
           / ref_w.norm(dim=1).clamp_min(torch.finfo(torch.float64).tiny))
    own = rmse(triples, w)
    return {
        "factor_gap_max": float(gap.max()),
        "factor_gap_mean": float(gap.mean()),
        "rmse_gap": abs(sync_rmse - own) / own,
        "rmse_ref_gap": abs(own - ref_rmse) / ref_rmse,
        "updates_short": float(updates_short),
    }
