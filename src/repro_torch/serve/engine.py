"""Batched serving: the decode step of every model family
(``repro.serve.engine`` in PyTorch).

Cache policy, as in the reference:

* attention layers: a ring buffer of width ``W`` -- the full ``seq_len``
  for decode_32k, ``cfg.serve_window`` for the long_500k sliding-window
  shape.  Entries are roped at their absolute positions when inserted.
* Mamba layers: the O(1) recurrent state, ``h`` float32 ``[Lm, B, di,
  ds]`` and the conv tail bfloat16 ``[Lm, B, d_conv - 1, di]``.
* audio (enc-dec): the cross-attention K/V of the encoder memory
  ``[L, B, T, Hkv, dh]`` (the context) and a 1,024-row self-attention
  ring, whose ``cache_len`` starts at 0.

A state the reference keeps as ``{}`` (no attention layer, no Mamba
layer, no memory) is ``None`` here.  The hybrid's attention layer of
period ``p`` has cache row ``p`` and its Mamba layer at position ``j``
state row ``p * (attn_every - 1) + j - 1``, the reference's reshape of
the stacked rows into periods.

``decode_step`` consumes ONE token per request and returns (logits,
new_state).  It updates the caches and Mamba states **in place**: a
functional copy of a cache that holds tens of GB would cost a copy of it
every step.  So the state passed in is consumed -- its tensors become
the new state's.  The ring insert lives beside its one caller,
``models.attention.decode_attention``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, mamba, moe
from repro_torch.models import model as model_lib
from repro_torch.models.layers import rmsnorm

_SELF_RING_ENCDEC = 1024      # decoder self-attention ring for enc-dec


@dataclasses.dataclass
class ServeState:
    cache_k: torch.Tensor | None   # [La, B, W, Hkv, dh] (None: no attention)
    cache_v: torch.Tensor | None
    cache_len: torch.Tensor        # [B] int32 absolute position counter
    mamba_state: dict | None       # {"h": [Lm,B,di,ds], "conv": [Lm,B,dc-1,di]}
    mem_k: torch.Tensor | None     # cross-attn K [L, B, T, Hkv, dh]
    mem_v: torch.Tensor | None


def _n_attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for i in range(cfg.n_layers) if cfg.is_attn_layer(i))


def _n_mamba_layers(cfg: ModelConfig) -> int:
    return cfg.n_layers - _n_attn_layers(cfg)


def cache_width(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.arch_type == "audio":
        return _SELF_RING_ENCDEC
    if cfg.serve_window is not None and seq_len > 32_768:
        return cfg.serve_window
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None) -> ServeState:
    """Zeroed caches on ``device`` (the GPU unless ``device="cpu"``).
    Attention caches start "full": ``cache_len = seq_len`` for every
    request, so the first step writes ring slot ``seq_len % W`` and
    attends to all W rows.  The enc-dec self ring starts empty
    (``cache_len = 0``): its context is the cross-attention memory."""
    device = resolve_device(device)
    w = cache_width(cfg, seq_len)
    kv = (cfg.n_kv_heads, cfg.dh)
    ck = cv = ms = mk = mv = None
    la, lm = _n_attn_layers(cfg), _n_mamba_layers(cfg)
    if la:
        ck = torch.zeros((la, batch, w) + kv, dtype=dtype, device=device)
        cv = torch.zeros((la, batch, w) + kv, dtype=dtype, device=device)
    if lm:
        one = mamba.init_decode_state(cfg, batch, device)
        ms = {k: torch.zeros((lm,) + t.shape, dtype=t.dtype, device=device)
              for k, t in one.items()}
    if cfg.enc_dec:
        mk = torch.zeros((cfg.n_layers, batch, seq_len) + kv, dtype=dtype,
                         device=device)
        mv = torch.zeros_like(mk)
    start = torch.full((batch,), 0 if cfg.enc_dec else seq_len,
                       dtype=torch.int32, device=device)
    return ServeState(ck, cv, start, ms, mk, mv)


def _ffn(lp: model_lib.Layer, cfg, x: torch.Tensor) -> torch.Tensor:
    if lp.ffn is None:
        return x
    h2 = rmsnorm(x, lp.norm2, cfg.norm_eps)
    if isinstance(lp.ffn, moe.MoE):
        y, _ = moe.apply(lp.ffn, cfg, h2)
    else:
        y = model_lib._mlp_apply(lp.ffn, cfg, h2)
    return x + y


def _decode_layer(lp: model_lib.Layer, cfg, x, ck, cv, clen):
    h = rmsnorm(x, lp.norm1, cfg.norm_eps)
    # insert-then-attend (the cache update happens inside decode_attention)
    x = x + attention.decode_attention(lp.mix, cfg, h, ck, cv, clen)
    return _ffn(lp, cfg, x)


def _decode_mamba_layer(lp: model_lib.Layer, cfg, x, mstate: dict):
    h = rmsnorm(x, lp.norm1, cfg.norm_eps)
    x = x + mamba.apply_decode(lp.mix, cfg, h, mstate)
    return _ffn(lp, cfg, x)


def _decode_encdec_layer(lp: model_lib.Layer, cfg, x, ck, cv, clen, mk, mv):
    h = rmsnorm(x, lp.norm1, cfg.norm_eps)
    # the self ring counts generated tokens; the memory holds the context
    x = x + attention.decode_attention(lp.mix, cfg, h, ck, cv, clen)
    hx = rmsnorm(x, lp.norm_x, cfg.norm_eps)
    x = x + attention.cross_attention_decode(lp.cross, cfg, hx, mk, mv)
    return _ffn(lp, cfg, x)


def _mamba_rows(state: ServeState, i: int) -> dict:
    """Layer ``i``'s rows of the stacked Mamba state, as views."""
    return {k: t[i] for k, t in state.mamba_state.items()}


@torch.no_grad()
def decode_step(params: model_lib.Model, cfg: ModelConfig,
                token: torch.Tensor, state: ServeState):
    """token: [B, 1] int -> (logits [B, vocab_padded] float32, new_state).

    Consumes ``state``: its caches and Mamba states are updated in place
    and become the new state's, which also counts the token
    (``cache_len + 1``)."""
    x = model_lib._embed_tokens(params, cfg, token)
    clen = state.cache_len
    kind = cfg.arch_type
    if kind in ("dense", "moe", "vlm"):
        for i, lp in enumerate(params.layers):
            x = _decode_layer(lp, cfg, x, state.cache_k[i],
                              state.cache_v[i], clen)
    elif kind == "ssm":
        for i, lp in enumerate(params.layers):
            x = _decode_mamba_layer(lp, cfg, x, _mamba_rows(state, i))
    elif kind == "hybrid":
        period = cfg.attn_every
        for p, j, lp in model_lib.hybrid_layers(params, cfg):
            if j == 0:
                x = _decode_layer(lp, cfg, x, state.cache_k[p],
                                  state.cache_v[p], clen)
            else:
                x = _decode_mamba_layer(
                    lp, cfg, x, _mamba_rows(state, p * (period - 1) + j - 1))
    elif kind == "audio":
        for i, lp in enumerate(params.layers):
            x = _decode_encdec_layer(lp, cfg, x, state.cache_k[i],
                                     state.cache_v[i], clen,
                                     state.mem_k[i], state.mem_v[i])
    else:
        raise ValueError(cfg.arch_type)
    new_state = dataclasses.replace(state, cache_len=clen + 1)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)      # x: [B, 1, d]
    return model_lib._logits(params, cfg, x)[:, 0], new_state
