"""Batched serving: the KV-cache decode step of the dense family
(``repro.serve.engine`` in PyTorch).

Cache policy, as in the reference: every attention layer has a ring
buffer of width ``W`` -- the full ``seq_len`` for decode_32k, and
``cfg.serve_window`` for the long_500k sliding-window shape.  Entries
are roped at their absolute positions when inserted.  The caches of the
other families (Mamba state, cross-attention memory) wait for those
families.

``decode_step`` consumes ONE token per request and returns (logits,
new_state).  It updates the caches **in place**: a functional copy of a
cache that holds tens of GB would cost a copy of it every step.  So the
state passed in is consumed -- its caches become the new state's.
The ring insert (the reference's ``_ring_insert``) lives beside its one
caller, ``models.attention.decode_attention``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention
from repro_torch.models import model as model_lib
from repro_torch.models.layers import rmsnorm

_SELF_RING_ENCDEC = 1024      # decoder self-attention ring for enc-dec


@dataclasses.dataclass
class ServeState:
    cache_k: torch.Tensor          # [L, B, W, Hkv, dh]
    cache_v: torch.Tensor
    cache_len: torch.Tensor        # [B] int32 absolute position counter


def cache_width(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.arch_type == "audio":
        return _SELF_RING_ENCDEC
    if cfg.serve_window is not None and seq_len > 32_768:
        return cfg.serve_window
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None) -> ServeState:
    """Zeroed caches on ``device`` (the GPU unless ``device="cpu"``) that
    start "full": ``cache_len = seq_len`` for every request, so the first
    step writes ring slot ``seq_len % W`` and attends to all W rows."""
    model_lib.check_family(cfg)
    device = resolve_device(device)
    w = cache_width(cfg, seq_len)
    shape = (cfg.n_layers, batch, w, cfg.n_kv_heads, cfg.dh)
    ck = torch.zeros(shape, dtype=dtype, device=device)
    cv = torch.zeros(shape, dtype=dtype, device=device)
    start = torch.full((batch,), seq_len, dtype=torch.int32, device=device)
    return ServeState(ck, cv, start)


def _decode_layer(lp: model_lib.Layer, cfg, x, ck, cv, clen):
    h = rmsnorm(x, lp.norm1, cfg.norm_eps)
    # insert-then-attend (the cache update happens inside decode_attention)
    x = x + attention.decode_attention(lp.mix, cfg, h, ck, cv, clen)
    if lp.ffn is not None:
        h2 = rmsnorm(x, lp.norm2, cfg.norm_eps)
        x = x + model_lib._mlp_apply(lp.ffn, cfg, h2)
    return x


@torch.no_grad()
def decode_step(params: model_lib.Model, cfg: ModelConfig,
                token: torch.Tensor, state: ServeState):
    """token: [B, 1] int -> (logits [B, vocab_padded] float32, new_state).

    Consumes ``state``: its caches are updated in place and become the
    new state's, which also counts the token (``cache_len + 1``)."""
    model_lib.check_family(cfg)
    x = model_lib._embed_tokens(params, cfg, token)
    clen = state.cache_len
    for i, lp in enumerate(params.layers):
        x = _decode_layer(lp, cfg, x, state.cache_k[i], state.cache_v[i],
                          clen)
    new_state = dataclasses.replace(state, cache_len=clen + 1)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)      # x: [B, 1, d]
    return model_lib._logits(params, cfg, x)[:, 0], new_state
