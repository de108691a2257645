"""PageRank's fixed point, and the same iteration in a lower precision.

The paper's update (Alg. 1) with symmetric weights ``1/sqrt(deg_u
deg_v)`` over an undirected edge list: the ranks solve ``r = reset +
(1 - reset) W r``.  ``fixed_point`` iterates that in float64 until it
stops moving; ``lowp_iteration`` is the control, the same iteration with
weights and ranks held in bfloat16 (products and sums in float32, as a
bfloat16 kernel computes them).
"""
from __future__ import annotations

import numpy as np
import torch

TOL = 1e-12            # the largest move of a rank, relative to it
MAX_ITERS = 2_000


def operator(edges: np.ndarray, n: int, device):
    """``(u, v, w)``: both directions of every edge and its float64
    weight (degrees count both endpoints, floored at 1)."""
    e = torch.as_tensor(np.asarray(edges, np.int64), device=device)
    deg = (torch.bincount(e[:, 0], minlength=n)
           + torch.bincount(e[:, 1], minlength=n)).to(torch.float64)
    deg = deg.clamp_min(1.0)
    w = 1.0 / torch.sqrt(deg[e[:, 0]] * deg[e[:, 1]])
    u = torch.cat([e[:, 0], e[:, 1]])
    v = torch.cat([e[:, 1], e[:, 0]])
    return u, v, torch.cat([w, w])


def _apply(u, v, w, r, n):
    return torch.zeros(n, dtype=w.dtype, device=w.device).index_add_(
        0, u, w * r[v])


def fixed_point(edges: np.ndarray, n: int, reset: float, device):
    """``[n]`` float64 ranks on ``device``, iterated until no rank moves
    by more than ``TOL`` of itself (every rank is at least ``reset``)."""
    u, v, w = operator(edges, n, device)
    r = torch.ones(n, dtype=torch.float64, device=device)
    for _ in range(MAX_ITERS):
        nxt = reset + (1 - reset) * _apply(u, v, w, r, n)
        moved = float(((nxt - r).abs() / nxt).max()) if n else 0.0
        r = nxt
        if moved < TOL:
            return r
    raise RuntimeError(f"the float64 iteration did not settle in "
                       f"{MAX_ITERS} steps")


def lowp_iteration(edges: np.ndarray, n: int, reset: float, device,
                   dtype=torch.bfloat16, iters: int = 200):
    """The control: ``[n]`` ranks (in ``dtype``) of the iteration with
    weights and ranks stored in ``dtype``, iterated until they stop
    changing (or ``iters`` steps)."""
    u, v, w = operator(edges, n, device)
    w = w.to(dtype).float()
    r = torch.ones(n, dtype=dtype, device=device)
    for _ in range(iters):
        nxt = (reset + (1 - reset) * _apply(u, v, w, r.float(), n)).to(dtype)
        same = torch.equal(nxt, r)
        r = nxt
        if same:
            break
    return r


def compare(ref: np.ndarray, rank: np.ndarray, total_rank: float,
            top2: float) -> dict:
    """The numbers one answer is judged by: the worst and the mean
    relative gap of a rank from the float64 fixed point, the total-rank
    sync against the float64 sum of the answer's own ranks (relative),
    and the second-largest-rank sync against the answer's own second
    largest rank (exact)."""
    rank = np.asarray(rank, np.float64)
    if rank.shape != ref.shape or not np.isfinite(rank).all():
        return {"rank_gap_max": float("inf"), "rank_gap_mean": float("inf"),
                "total_rank_gap": float("inf"), "top2_gap": float("inf")}
    rel = np.abs(rank - ref) / ref
    total = float(rank.sum())
    second = float(np.partition(rank, -2)[-2]) if rank.size > 1 else 0.0
    return {
        "rank_gap_max": float(rel.max()),
        "rank_gap_mean": float(rel.mean()),
        "total_rank_gap": abs(total_rank - total) / total,
        "top2_gap": abs(top2 - second),
    }
