"""Primitive layers of the LLM stack: initialisers, RMSNorm, RoPE and the
MLP activations (``repro.models.layers`` in PyTorch).

The initialisers draw from an explicit ``torch.Generator`` on the target
device, with the reference's distributions and scales: the draw is a
float32 standard normal, cast to the parameter dtype, then scaled in
that dtype.  The values are not the reference's (``jax.random`` and
torch's generators differ); the tests carry the reference's parameters
across instead (``repro_torch.interop``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def linear_init(gen: torch.Generator, d_in: int, d_out: int,
                dtype=torch.bfloat16) -> torch.Tensor:
    """A ``[d_in, d_out]`` weight (applied as ``x @ w``), Glorot-normal."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.to(dtype) * scale


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.to(dtype) * 0.02


def rmsnorm_init(d: int, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * scale).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding over non-interleaved halves.

    x: [..., S, H, dh]; positions: broadcastable to [..., S] (absolute
    positions).  The angles are float32; the rotation is computed in
    float32 and cast back to x's dtype.
    """
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].to(torch.float32) * freqs     # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                       # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]
