"""Deterministic synthetic data (``repro.data.pipeline`` in PyTorch):
the language models' training batches (``make_batch``), the dry run's
input specs, and live-graph mutation traffic for online serving
(DESIGN.md §13).

Batches and streams draw on the host with numpy, by the reference's
seeded ``default_rng`` calls in the reference's order, so a batch or a
stream is bitwise the reference's.  The specs (``train_input_specs``,
``decode_input_specs``, ``param_specs_struct``) are tensors on the
``meta`` device: the reference's keys, shapes and dtypes, and no
memory behind them (the counterpart of its ``ShapeDtypeStruct``s).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


def _split_train_seq(cfg, seq_len: int):
    """``(front, text)`` positions of a training sequence: the audio
    family splits it between encoder frames and decoder tokens; the vlm
    carves its patch positions out of it."""
    if cfg.arch_type == "audio":
        return seq_len // 2, seq_len // 2
    if cfg.arch_type == "vlm":
        return cfg.n_frontend_tokens, seq_len - cfg.n_frontend_tokens
    return 0, seq_len


def make_batch(cfg, batch: int, seq_len: int, seed: int = 0, device=None):
    """A synthetic training batch on ``device`` (the GPU unless
    ``device="cpu"``): ``tokens`` and ``labels`` int32 [B, text], the
    labels the tokens shifted by one, from an order-0 stream over a
    skewed (Dirichlet) unigram distribution of the first min(vocab,
    4,096) ids, so the loss can fall; plus float32 ``frames`` (audio) or
    ``patches`` (vlm) [B, front, d] of standard normals."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    front, txt = _split_train_seq(cfg, seq_len)
    probs = rng.dirichlet(np.full(min(cfg.vocab, 4096), 0.5))
    ids = rng.choice(len(probs), size=(batch, txt + 1), p=probs)
    up = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(
        device)
    out = {"tokens": up(ids[:, :-1], np.int32),
           "labels": up(ids[:, 1:], np.int32)}
    if cfg.arch_type in ("audio", "vlm"):
        name = "frames" if cfg.arch_type == "audio" else "patches"
        out[name] = up(rng.normal(size=(batch, front, cfg.d_model)),
                       np.float32)
    return out


# ----------------------------------------------------------------------
# Dry-run specs (meta tensors: shapes and dtypes, no memory)
# ----------------------------------------------------------------------

META = torch.device("meta")


def train_input_specs(cfg, shape) -> dict:
    """A training (or, without ``labels``, prefill) batch of ``shape`` as
    meta tensors: int32 ``tokens`` and ``labels`` [B, text], plus float32
    ``frames`` (audio) or ``patches`` (vlm) [B, front, d]."""
    b = shape.global_batch
    front, txt = _split_train_seq(cfg, shape.seq_len)
    out = {"tokens": torch.empty((b, txt), dtype=torch.int32, device=META),
           "labels": torch.empty((b, txt), dtype=torch.int32, device=META)}
    if cfg.arch_type in ("audio", "vlm"):
        name = "frames" if cfg.arch_type == "audio" else "patches"
        out[name] = torch.empty((b, front, cfg.d_model), dtype=torch.float32,
                                device=META)
    return out


def decode_input_specs(cfg, shape):
    """``(token, ServeState)`` for ``serve_step`` at ``shape``, on meta:
    int32 ``token`` [B, 1] and ``serve.engine.init_cache``'s state."""
    from repro_torch.serve import engine as serve_engine
    b = shape.global_batch
    token = torch.empty((b, 1), dtype=torch.int32, device=META)
    return token, serve_engine.init_cache(cfg, b, shape.seq_len,
                                          device=META)


def param_specs_struct(cfg, dtype=torch.bfloat16):
    """The whole parameter tree as a ``Model`` on meta (nothing drawn,
    nothing allocated)."""
    from repro_torch.models.model import Model
    return Model(cfg, None, dtype, META)


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
