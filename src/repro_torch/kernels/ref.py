"""Plain PyTorch oracles for the port's kernels (the correctness contract)."""
from __future__ import annotations

import torch


def ell_spmv_ref(nbrs: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                 row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """y[v] = row_mask[v] * sum_j w[v,j] * x[nbrs[v,j]]."""
    gathered = x[nbrs.long()]                 # [Nv, D, F]
    y = (w[..., None] * gathered).sum(dim=1)
    if row_mask is not None:
        y = y * row_mask.to(y.dtype)[:, None]
    return y


def als_normal_eq_ref(nbrs: torch.Tensor, mask: torch.Tensor,
                      ratings: torch.Tensor, x: torch.Tensor):
    """A[v] = sum_j m X_j X_j^T, b[v] = sum_j m r X_j, X_j = x[nbrs[v,j]]."""
    xg = x[nbrs.long()]                       # [Nv, D, d]
    xm = xg * mask.to(x.dtype)[..., None]
    a = torch.einsum("vdi,vdj->vij", xm, xg)
    b = torch.einsum("vdi,vd->vi", xm, ratings)
    return a, b


def decode_window_attention_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                kv_len: torch.Tensor) -> torch.Tensor:
    """Decode attention over the first ``kv_len`` rows of a KV cache, in
    float32: q [B, H, dh]; k/v [B, W, Hkv, dh]; kv_len [B].  Query head h
    reads KV head h // (H / Hkv) (the reference's grouped view
    ``q.reshape(b, hkv, n_rep, dh)``).  Returns float32 [B, H, dh]."""
    b, h, dh = q.shape
    w, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / (dh ** 0.5)
    qg = q.to(torch.float32).reshape(b, hkv, h // hkv, dh)
    s = torch.einsum("bgrd,bwgd->bgrw", qg, k.to(torch.float32)) * scale
    pos = torch.arange(w, device=k.device)[None, :]
    valid = (pos < kv_len.to(k.device)[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrw,bwgd->bgrd", p, v.to(torch.float32))
    return o.reshape(b, h, dh)


def decode_window_attention_partial_ref(q: torch.Tensor, k: torch.Tensor,
                                        v: torch.Tensor,
                                        kv_len: torch.Tensor):
    """The partial of ``decode_window_attention_ref`` over the first
    ``kv_len`` rows (0 allowed), in float32: ``(o [B, H, dh], m [B, H],
    l [B, H])`` with m the scores' max, l = sum_t e^(s_t - m) and o =
    sum_t e^(s_t - m) v_t, unnormalised; a request with no valid row
    gives o = 0, m = -inf, l = 0.  ``o / l`` is the attention."""
    b, h, dh = q.shape
    w, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / (dh ** 0.5)
    qg = q.to(torch.float32).reshape(b, hkv, h // hkv, dh)
    s = torch.einsum("bgrd,bwgd->bgrw", qg, k.to(torch.float32)) * scale
    pos = torch.arange(w, device=k.device)[None, :]
    valid = (pos < kv_len.to(k.device)[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - torch.where(
        torch.isinf(m), 0.0, m)[..., None]), 0.0)
    o = torch.einsum("bgrw,bwgd->bgrd", p, v.to(torch.float32))
    return o.reshape(b, h, dh), m.reshape(b, h), p.sum(-1).reshape(b, h)
