"""Power-law graphs by the configuration model, made on the device.

Rewritten from ``repro_torch.core.graph.zipf_edges`` (commit f7cd5cd):
Zipf(alpha) degrees, the stubs paired uniformly at random, self loops
and duplicate edges dropped, each edge ``(lo, hi)`` with ``lo < hi``,
sorted.  Two changes, so that every seed does the same work: the
degrees are the Zipf law's quantiles rather than draws, and they sit on
the vertex ids in one fixed layout, a random permutation drawn once
from ``LAYOUT_SEED``; ``--seed`` draws the pairing of the stubs.  No
degree is clipped below ``n - 1``, the most distinct neighbours a
vertex can have.
"""
from __future__ import annotations

import math

from . import generator

_ZETA_TERMS = 10_000
# the degrees' placement on the ids, the same for every seed: the
# source draws each vertex's degree alone, so an id says nothing of it
LAYOUT_SEED = 0


def zeta(alpha: float) -> float:
    """Riemann zeta at ``alpha > 1``: the first terms summed, the rest by
    Euler-Maclaurin (error far below float64's rounding here)."""
    if alpha <= 1:
        raise ValueError(f"Zipf needs alpha > 1, got {alpha}")
    k = _ZETA_TERMS
    head = math.fsum(j ** -alpha for j in range(1, k))
    tail = (k ** (1 - alpha) / (alpha - 1) + 0.5 * k ** -alpha
            + alpha * k ** (-alpha - 1) / 12)
    return head + tail


def degree_quantiles(torch, n: int, alpha: float, device):
    """``[n]`` int64, ascending: the Zipf(alpha) law read at the
    quantiles ``(i + 1/2) / n``, at most ``n - 1``."""
    if n < 2:
        raise ValueError(f"a graph needs two vertices, got {n}")
    k = torch.arange(1, n - 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(k.pow(-alpha), 0) / zeta(alpha)
    u = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    return torch.searchsorted(cdf, u) + 1


def degrees(torch, n: int, alpha: float, device):
    """``[n]`` int64 stubs of each vertex: the quantiles in the fixed
    layout."""
    deg = torch.empty(n, dtype=torch.int64, device=device)
    deg[torch.randperm(n, generator=generator(torch, LAYOUT_SEED, device),
                       device=device)] = degree_quantiles(torch, n, alpha,
                                                          device)
    return deg


def zipf_edges(torch, n: int, alpha: float, seed: int, device):
    """``[Ne, 2]`` int64 undirected edges on ``device``: the stubs of
    ``degrees`` paired at random from ``seed``."""
    stubs = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=device),
        degrees(torch, n, alpha, device))
    stubs = stubs[torch.randperm(stubs.numel(),
                                 generator=generator(torch, seed, device),
                                 device=device)]
    pairs = stubs[: 2 * (stubs.numel() // 2)].view(-1, 2)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    a = torch.minimum(pairs[:, 0], pairs[:, 1])
    b = torch.maximum(pairs[:, 0], pairs[:, 1])
    key = torch.unique(a * n + b)
    return torch.stack([key // n, key % n], dim=1)
