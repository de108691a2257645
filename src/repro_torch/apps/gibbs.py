"""Gibbs sampling on a Markov Random Field (paper §5.4), on the port.

The port of ``repro.apps.gibbs``.  The chromatic engine is the parallel
colored Gibbs sampler of Gonzalez et al.: same-colored variables are
conditionally independent given the rest, so sampling a color phase in
parallel equals some sequential scan.

Ising pairwise MRF.  Vertex data: the current spin, a per-vertex PRNG
key (split every update: the update function is stateless, so the RNG
state lives in the data graph), and the sufficient statistics of the
marginal estimates.

The keys are the reference's: JAX's threefry-2x32, written here in
torch integer ops so that the port draws the same uniform bits as the
reference from the same keys, on the CPU and on the card.  The words of
a key are held in int64 tensors with values in ``[0, 2^32)``: each sum
and shift is masked with ``0xFFFFFFFF`` (torch's uint32 has few CUDA
ops).  The split and the bits are those of JAX's *partitionable*
threefry (``jax_threefry_partitionable``, on by default in JAX 0.9):
``split`` hashes the counters ``(0, i)`` and ``uniform`` takes the XOR
of the two words hashed at counter ``(0, 0)``.  The spins cannot be
bitwise: JAX's ``sigmoid`` and torch's round a few inputs in a million
one ulp apart, so where ``u`` and ``p`` are that close the draws may
differ.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.coloring import greedy_coloring
from repro_torch.core.graph import DataGraph
from repro_torch.core.update import (Consistency, ScopeBatch, UpdateFn,
                                     UpdateResult)

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """JAX's threefry-2x32 hash (20 rounds) of the counters ``(x1, x2)``
    under the key ``(k1, k2)``, elementwise over broadcast int64 tensors
    holding 32-bit words; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def prng_key(seeds) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s key data for each seed: ``[..., 2]``
    int64 words ``(seed >> 32, seed & 0xFFFFFFFF)`` (non-negative seeds;
    the reference's int32 seeds give a high word of 0)."""
    s = torch.as_tensor(seeds, dtype=torch.int64)
    return torch.stack([(s >> 32) & MASK32, s & MASK32], dim=-1)


def split(key: torch.Tensor):
    """``jax.random.split(key)`` for ``[..., 2]`` keys: the two new keys,
    the hash of the counters ``(0, 0)`` and ``(0, 1)``."""
    k1, k2 = key[..., 0, None], key[..., 1, None]
    lo = torch.arange(2, dtype=key.dtype, device=key.device)
    w1, w2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)   # [..., 2]
    return (torch.stack([w1[..., 0], w2[..., 0]], dim=-1),
            torch.stack([w1[..., 1], w2[..., 1]], dim=-1))


def uniform(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key)``, a float32 scalar in [0, 1) for each
    ``[..., 2]`` key: the 23 high bits of the random word as the mantissa
    of a number in [1, 2), minus 1."""
    k1, k2 = key[..., 0], key[..., 1]
    zero = torch.zeros_like(k1)
    w1, w2 = threefry2x32(k1, k2, zero, zero)
    bits = ((w1 ^ w2) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def make_update(beta: float, field: float = 0.0, burn_in: int = 0) -> UpdateFn:
    """Ising Gibbs sweep; spins in {0,1}, energy -beta * s_u s_v (±1)."""
    def update(scope: ScopeBatch) -> UpdateResult:
        key = scope.v_data["key"]                    # [B, 2] int64 words
        nbr_spin = scope.nbr_data["spin"]            # [B, D] int32
        pm = torch.where(scope.nbr_mask, 2.0 * nbr_spin - 1.0, 0.0)
        local = 2.0 * (beta * pm.sum(dim=1) + field)
        p_up = torch.sigmoid(local)
        new_key, draw_key = split(key)
        spin = (uniform(draw_key) < p_up).to(torch.int32)
        sweep = scope.v_data["sweep"] + 1
        collect = (sweep > burn_in).to(torch.float32)
        return UpdateResult(
            v_data={
                "spin": spin,
                "key": new_key,
                "sweep": sweep,
                "ones": scope.v_data["ones"] + collect * spin,
                "n": scope.v_data["n"] + collect,
            },
            resched_self=torch.ones(spin.shape, dtype=torch.bool,
                                    device=spin.device),  # keep sweeping
        )
    return UpdateFn(update, Consistency.EDGE, name="gibbs")


@dataclasses.dataclass
class IsingProblem:
    graph: DataGraph
    beta: float
    field: float
    edges: np.ndarray


def ising_problem(edges: np.ndarray, n_vertices: int, beta: float,
                  field: float = 0.0, seed: int = 0,
                  colors: np.ndarray | None = None,
                  device=None) -> IsingProblem:
    """The reference's problem: spins drawn from ``default_rng(seed)``,
    vertex ``v``'s key ``PRNGKey(seed * 1000003 + v)``, greedy colors
    (or ``colors``, a coloring the caller already has).  The graph's
    tensors go to ``device`` (default: the GPU)."""
    rng = np.random.default_rng(seed)
    base = seed * 1000003
    keys = prng_key(np.arange(base, base + n_vertices, dtype=np.int64))
    g = DataGraph.from_edges(
        n_vertices, edges,
        vertex_data={
            "spin": rng.integers(0, 2, n_vertices).astype(np.int32),
            "key": keys,
            "sweep": np.zeros(n_vertices, np.int32),
            "ones": np.zeros(n_vertices, np.float32),
            "n": np.zeros(n_vertices, np.float32),
        }, device=device)
    g = g.with_colors(greedy_coloring(n_vertices, edges)
                      if colors is None else colors)
    return IsingProblem(g, beta, field, np.asarray(edges))


def build(problem: IsingProblem, *, burn_in: int = 0):
    """Uniform facade triple ``(graph, update, syncs)`` for a problem
    from ``ising_problem`` (no syncs: the marginal statistics live on
    the vertices)."""
    return (problem.graph,
            make_update(problem.beta, field=problem.field, burn_in=burn_in),
            ())


def marginals(vertex_data) -> np.ndarray:
    ones = vertex_data["ones"].cpu().numpy()
    n = np.maximum(vertex_data["n"].cpu().numpy(), 1.0)
    return ones / n


def exact_marginals(edges: np.ndarray, n_vertices: int, beta: float,
                    field: float = 0.0) -> np.ndarray:
    """Brute-force enumeration oracle (at most 16 vertices)."""
    if n_vertices > 16:
        raise ValueError(f"exact_marginals enumerates 2^n states: n = "
                         f"{n_vertices} > 16")
    states = np.arange(2 ** n_vertices)
    bits = ((states[:, None] >> np.arange(n_vertices)) & 1)  # [S, Nv]
    pm = 2.0 * bits - 1.0
    energy = field * pm.sum(axis=1)
    for u, v in edges:
        energy = energy + beta * pm[:, u] * pm[:, v]
    w = np.exp(energy - energy.max())
    w = w / w.sum()
    return (w[:, None] * bits).sum(axis=0)
