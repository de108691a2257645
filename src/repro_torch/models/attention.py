"""GQA attention: self-attention for prefill (full or sliding-window
causal, or bidirectional in the audio encoder), cross-attention over an
encoder memory, and cached decode (``repro.models.attention`` in
PyTorch).

Parameters live in an ``Attention`` module (the reference's
``attention.init`` pytree): ``wq``, ``wk``, ``wv`` as ``[d, heads * dh]``
and ``wo`` as ``[heads * dh, d]``, applied as ``x @ w``, plus the
float32 ``q_norm`` / ``k_norm`` scales where the config has qk_norm.

Decode takes its attention from the hand-written CUDA kernel
(``kernels/window_attention``): the new token's K/V go into the ring
slot first, in place, and the query attends to the cache's valid
prefix.  The decoder's cross-attention at decode (one query against an
all-valid encoder memory) is the same function with ``kv_len = T``, so
it takes the kernel too (``cross_attention_decode``).  On DTensors (the
partitioned dry run) the heads are laid out before the split
(``shardctx.heads_hint``), the flash loop runs on each rank's heads or
queries (``launch.local_rules.by_heads``), and decode runs B4 on each
rank's rows of the cache and merges the ranks
(``kernels.window_attention_spmd``).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import window_attention_spmd as spmd
from repro_torch.kernels.window_attention import window_attention
from repro_torch.launch import local_rules, shardctx
from repro_torch.models.layers import linear_init, rmsnorm, rmsnorm_init, rope


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Attention(nn.Module):
    """One layer's attention weights.  With ``gen`` the weights are drawn
    from it (``linear_init``); without, they are left uninitialised on
    ``device``, for ``interop.params_from_arrays`` to fill."""

    def __init__(self, cfg, gen: torch.Generator | None = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        d, dh = cfg.d_model, cfg.dh
        shapes = {"wq": (d, cfg.n_heads * dh), "wk": (d, cfg.n_kv_heads * dh),
                  "wv": (d, cfg.n_kv_heads * dh), "wo": (cfg.n_heads * dh, d)}
        for name, shape in shapes.items():
            w = (linear_init(gen, *shape, dtype) if gen is not None
                 else torch.empty(shape, dtype=dtype, device=device))
            setattr(self, name, _param(w))
        if cfg.qk_norm:
            dev = gen.device if gen is not None else device
            self.q_norm = _param(rmsnorm_init(dh, dev))
            self.k_norm = _param(rmsnorm_init(dh, dev))


def _qkv(p: Attention, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Projections, qk_norm and rope at ``positions``:
    q [B,S,H,dh], k/v [B,S,Hkv,dh]."""
    b, s, _ = x.shape
    dh = cfg.dh
    q = _heads(x @ p.wq, cfg.n_heads, dh)
    k = _heads(x @ p.wk, cfg.n_kv_heads, dh)
    v = _heads(x @ p.wv, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _heads(t: torch.Tensor, n_heads: int, dh: int) -> torch.Tensor:
    """[B, S, H * dh] -> [B, S, H, dh] (on DTensors laid out for the
    split first, ``shardctx.heads_hint``)."""
    b, s, _ = t.shape
    return shardctx.heads_hint(t, n_heads).reshape(b, s, n_heads, dh)


def _sdpa(q, k, v, mask, n_rep: int):
    """q: [B,S,H,dh], k/v: [B,T,Hkv,dh]; mask [S,T] or [B,S,T] additive."""
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    s = s + mask
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", p, v)


def causal_mask(s: int, window: int | None = None, device=None):
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    ok = j <= i
    if window is not None:
        ok &= (i - j) < window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, float("-inf"))


_FLASH_THRESHOLD = 2048
_QC = 512      # query chunk
_KC = 1024     # kv chunk


def _flash_q_block(qb, kr, vr, q0: int, causal: bool, window: int | None,
                   scale: float) -> torch.Tensor:
    """One query chunk qb [B,H,qc,dh] (first position ``q0``) against
    every KV chunk kr/vr [nk,B,H,kc,dh] by the online softmax; returns
    [B,H,qc,dh] in q's dtype."""
    b, h, qc, dh = qb.shape
    kc = kr.shape[3]
    dev = qb.device
    qpos = q0 + torch.arange(qc, device=dev)
    neg = torch.tensor(float("-inf"), device=dev)
    zero = torch.zeros((), device=dev)
    m_p = torch.full((b, h, qc), float("-inf"), device=dev)
    l_p = torch.zeros((b, h, qc), device=dev)
    acc = torch.zeros((b, h, qc, dh), device=dev)
    for ki in range(kr.shape[0]):
        kb, vb = kr[ki], vr[ki]
        kpos = ki * kc + torch.arange(kc, device=dev)
        sc = torch.einsum("bhqd,bhkd->bhqk", qb, kb) * scale
        ok = torch.ones((qc, kc), dtype=torch.bool, device=dev)
        if causal:
            ok &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            ok &= (qpos[:, None] - kpos[None, :]) < window
        sc32 = torch.where(ok, sc.float(), neg)
        m_c = torch.maximum(m_p, sc32.amax(-1))
        # fully masked blocks keep m == -inf: guard the exps so the
        # running state stays finite (their entries are 0 anyway)
        m_safe = torch.where(torch.isfinite(m_c), m_c, zero)
        pr = torch.exp(sc.float() - m_safe[..., None]).to(qb.dtype)
        pr = torch.where(ok, pr, 0)
        alpha = torch.where(torch.isfinite(m_p), torch.exp(m_p - m_safe),
                            zero)
        l_p = alpha * l_p + pr.float().sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", pr, vb).float()
        m_p = m_c
    return (acc / torch.clamp(l_p, min=1e-30)[..., None]).to(qb.dtype)


def flash_attention(q, k, v, causal: bool, window: int | None,
                    n_rep: int, q_start: int = 0) -> torch.Tensor:
    """Memory-bounded attention: an online softmax over KV chunks inside
    a loop over query chunks, so the live score block is [B,H,QC,KC]
    instead of [B,H,S,S].  As in the reference, the probability tile is
    stored in q's dtype (bf16 for bf16 models) while the running max and
    denominator stay float32.  S and T must be multiples of the chunks
    (or smaller than them).  Where autograd records, each query chunk
    runs under a checkpoint, as the reference checkpoints its q block:
    backward then holds one chunk's score tiles, not all nq x nk.  The
    queries sit at positions ``q_start`` on.  On DTensors it runs on each
    rank's requests and heads, or its block of queries
    (``launch.local_rules.by_heads``)."""
    if shardctx.is_distributed(q):
        return local_rules.by_heads(
            lambda ql, kl, vl, r, q0: flash_attention(ql, kl, vl, causal,
                                                      window, r, q0),
            q, k, v, n_rep)
    b, s, h, dh = q.shape
    t = k.shape[1]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    qc = min(_QC, s)
    kc = min(_KC, t)
    nq, nk = s // qc, t // kc
    qr = q.reshape(b, nq, qc, h, dh).permute(1, 0, 3, 2, 4)   # [nq,B,H,qc,dh]
    kr = k.reshape(b, nk, kc, h, dh).permute(1, 0, 3, 2, 4)
    vr = v.reshape(b, nk, kc, h, dh).permute(1, 0, 3, 2, 4)
    block = _flash_q_block
    if torch.is_grad_enabled():
        block = functools.partial(checkpoint, _flash_q_block,
                                  use_reentrant=False)
    ob = torch.stack([block(qr[qi], kr, vr, q_start + qi * qc, causal,
                            window, dh ** -0.5) for qi in range(nq)])
    return ob.permute(1, 0, 3, 2, 4).reshape(b, s, h, dh)


def self_attention(p: Attention, cfg, x: torch.Tensor, positions,
                   causal: bool = True,
                   window: int | None | str = "cfg") -> torch.Tensor:
    b, s, d = x.shape
    if window == "cfg":
        window = cfg.window
    q, k, v = _qkv(p, cfg, x, positions)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if s > _FLASH_THRESHOLD:
        o = flash_attention(q, k, v, causal, window, n_rep)
    else:
        if causal:
            mask = causal_mask(s, window, x.device)
        else:
            mask = torch.zeros((s, s), dtype=torch.float32, device=x.device)
        o = _sdpa(q, k, v, mask, n_rep)
    return o.reshape(b, s, -1) @ p.wo


def cross_attention_init(cfg, gen: torch.Generator | None = None,
                         dtype=torch.bfloat16, device=None) -> Attention:
    """The cross-attention weights: the same parameters as ``Attention``."""
    return Attention(cfg, gen, dtype, device)


def _cross_q(p: Attention, cfg, x: torch.Tensor) -> torch.Tensor:
    """The cross-attention query [B,S,H,dh]: no rope, qk_norm on q."""
    q = _heads(x @ p.wq, cfg.n_heads, cfg.dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
    return q


def cross_attention(p: Attention, cfg, x: torch.Tensor, mem_k: torch.Tensor,
                    mem_v: torch.Tensor, mem_mask: torch.Tensor
                    ) -> torch.Tensor:
    """x: [B,S,d]; mem_k/v precomputed [B,T,Hkv,dh]; mem_mask [B,T] bool.

    As the reference: past 2,048 rows on either side the flash path runs
    with the memory taken as all valid (S and T multiples of its
    chunks); otherwise a dense softmax masked by ``mem_mask``."""
    b, s, _ = x.shape
    q = _cross_q(p, cfg, x)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k, v = mem_k, mem_v
    if max(s, k.shape[1]) > _FLASH_THRESHOLD:
        o = flash_attention(q, k, v, causal=False, window=None, n_rep=n_rep)
        return o.reshape(b, s, -1) @ p.wo
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mask = torch.where(mem_mask[:, None, None, :], zero, float("-inf"))
    sc = torch.einsum("bshd,bthd->bhst", q, k).float() * cfg.dh ** -0.5
    pr = torch.softmax(sc + mask, dim=-1).to(q.dtype)
    o = torch.einsum("bhst,bthd->bshd", pr, v)
    return o.reshape(b, s, -1) @ p.wo


def cross_attention_decode(p: Attention, cfg, x: torch.Tensor,
                           mem_k: torch.Tensor,
                           mem_v: torch.Tensor) -> torch.Tensor:
    """One query token a request against its whole memory: x [B,1,d],
    mem_k/v [B,T,Hkv,dh] (a layer's slice, read in place).  The memory is
    all valid, as the reference's decode step takes it, so this is the
    window-attention kernel's function at ``kv_len = T`` (float32 inside,
    cast to x's dtype before ``wo``).  Returns out [B,1,d]."""
    b, t = mem_k.shape[:2]
    q = _cross_q(p, cfg, x)
    kv_len = torch.full((b,), t, dtype=torch.int32, device=x.device)
    o = _attend(q[:, 0], mem_k, mem_v, kv_len)              # [B,H,dh] f32
    return _out_proj(p, o.to(x.dtype).reshape(b, 1, -1))


def mem_kv(p: Attention, cfg, mem: torch.Tensor):
    """The cross-attention K/V [B,T,Hkv,dh] of an encoder output
    [B,T,d]; qk_norm on K, no rope."""
    k = _heads(mem @ p.wk, cfg.n_kv_heads, cfg.dh)
    v = _heads(mem @ p.wv, cfg.n_kv_heads, cfg.dh)
    if cfg.qk_norm:
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    return k, v


# ----------------------------------------------------------------------
# Decode path: one query token against a KV cache.
# ----------------------------------------------------------------------

def _attend(q, k, v, kv_len):
    """B4: on one device the kernel over the whole cache; on a DTensor
    cache its partials on each rank's rows, merged over the ranks
    (``kernels.window_attention_spmd``)."""
    if shardctx.is_distributed(k):
        return spmd.sharded_window_attention(q, k, v, kv_len)
    return window_attention(q, k, v, kv_len)


def _ring_insert(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor):
    """In place: cache [B,W,H,dh] gets new [B,1,H,dh] at row slot [B]
    (on a DTensor cache each rank writes its own rows)."""
    if shardctx.is_distributed(cache):
        spmd.sharded_ring_insert(cache, new, slot)
        return cache
    b = cache.shape[0]
    cache[torch.arange(b, device=cache.device), slot] = new[:, 0].to(
        cache.dtype)
    return cache


def _out_proj(p: Attention, o: torch.Tensor) -> torch.Tensor:
    return o @ p.wo


def _masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """The kernel's function over any valid set ``valid`` [B,W] (not only
    a prefix), in float32: q [B,H,dh], k/v [B,W,Hkv,dh] -> [B,H,dh]."""
    b, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, hkv, h // hkv, dh)
    s = torch.einsum("bgrd,bwgd->bgrw", qg, k.float()) * dh ** -0.5
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    o = torch.einsum("bgrw,bwgd->bgrd", torch.softmax(s, dim=-1), v.float())
    return o.reshape(b, h, dh)


def decode_attention(p: Attention, cfg, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cache_len: torch.Tensor, slot: torch.Tensor | None = None):
    """x: [B,1,d]; cache_k/v: [B,W,Hkv,dh]; cache_len: [B] int32 tokens
    seen so far (the new token's absolute position).

    Insert-then-attend, as the reference: the new token's K/V go into
    ring slot ``cache_len % W`` (or ``slot`` [B], where given) first --
    in place, so cache_k/v are updated for the caller -- and the query
    attends to the cache alone, over the reference's valid set
    ``t < min(cache_len + 1, W) | t == slot``.  Without ``slot`` that set
    is always the prefix ``t < kv_len``, ``kv_len = min(cache_len + 1,
    W)``, which is the kernel's contract; kv_len is computed on the
    device.  A given slot past that prefix makes the set a prefix plus
    one row, which the kernel does not take: that call runs the same
    function as a masked softmax (deciding which waits for the device).
    The float32 attention is cast to x's dtype before ``wo``.  Returns
    out [B,1,d].
    """
    b = x.shape[0]
    pos = cache_len.long()[:, None]                       # position = len
    q, k, v = _qkv(p, cfg, x, pos)
    w = cache_k.shape[1]
    given = slot is not None
    slot = slot.long() if given else cache_len.long() % w
    _ring_insert(cache_k, k, slot)
    _ring_insert(cache_v, v, slot)
    kv_len = torch.clamp(cache_len + 1, max=w).to(torch.int32)
    if given and not bool((slot < kv_len).all()):
        t = torch.arange(w, device=x.device)[None, :]
        valid = (t < kv_len[:, None]) | (t == slot[:, None])
        o = _masked_attention(q[:, 0], cache_k, cache_v, valid)
    else:
        o = _attend(q[:, 0], cache_k, cache_v, kv_len)  # f32
    return _out_proj(p, o.to(x.dtype).reshape(b, 1, -1))
