"""Mamba-1 selective SSM block (falcon-mamba, jamba's Mamba layers):
``repro.models.mamba`` in PyTorch.

Prefill runs the diagonal recurrence ``h_t = a_t * h_{t-1} + b_t`` in
chunks of 256 steps, carrying the ``[B, d_inner, d_state]`` state from
chunk to chunk.  Inside a chunk the pairs ``(a, b)`` compose
associatively, ``(a, b) o (a', b') = (a a', a' b + b')``, and a
Hillis-Steele scan applies that in log2(chunk) rounds of whole-tensor
ops (8 at 256): the counterpart of the reference's
``lax.associative_scan``, whose tree sums in another order.  The
``[B, chunk, d_inner, d_state]`` tensors are built inside the chunk
loop, so peak memory is one chunk's, in backward too (a checkpoint a
chunk).

Decode is the O(1) recurrent step; it updates the state it is given in
place (``h`` float32, and the conv tail, which is bfloat16 whatever the
model's dtype, as in the reference).  On DTensors the input projection
is two products, one a half (``_in_proj``), and the scan runs on each
rank's requests and channels (``launch.local_rules.by_channels``).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import local_rules, shardctx
from repro_torch.models.layers import linear_init

_CHUNK = 256


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


class Mamba(nn.Module):
    """One Mamba layer's weights, named and drawn as the reference's
    ``mamba.init``: ``in_proj [d, 2 di]``, ``conv_w [d_conv, di]`` (a
    float32 normal times 0.2, then cast), ``conv_b``, ``x_proj [di, dtr +
    2 ds]``, float32 ``dt_proj [dtr, di]``, ``dt_bias = log(expm1(0.01))``,
    ``A_log = log([1..ds])`` and ``D = 1``, and ``out_proj [di, d]``.
    Without ``gen`` the weights are left uninitialised on ``device``."""

    def __init__(self, cfg, gen: torch.Generator | None = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        d, di, ds, dc = cfg.d_model, cfg.d_inner, cfg.ssm.d_state, \
            cfg.ssm.d_conv
        dtr = dt_rank(cfg)
        dev = gen.device if gen is not None else device

        def lin(d_in, d_out, dt=dtype):
            if gen is None:
                return _param(torch.empty((d_in, d_out), dtype=dt,
                                          device=dev))
            return _param(linear_init(gen, d_in, d_out, dt))
        f32 = torch.float32
        self.in_proj = lin(d, 2 * di)
        if gen is None:
            self.conv_w = _param(torch.empty((dc, di), dtype=dtype,
                                             device=dev))
        else:
            w = torch.randn((dc, di), generator=gen, device=dev, dtype=f32)
            self.conv_w = _param((w * 0.2).to(dtype))
        self.conv_b = _param(torch.zeros((di,), dtype=dtype, device=dev))
        self.x_proj = lin(di, dtr + 2 * ds)
        self.dt_proj = lin(dtr, di, f32)
        bias = torch.log(torch.expm1(torch.tensor(0.01, dtype=f32)))
        self.dt_bias = _param(torch.zeros((di,), dtype=f32, device=dev)
                              + bias.to(dev))
        a = torch.arange(1, ds + 1, dtype=f32, device=dev)[None].repeat(di, 1)
        self.A_log = _param(torch.log(a))
        self.D = _param(torch.ones((di,), dtype=f32, device=dev))
        self.out_proj = lin(di, d)


def _selective(p: Mamba, cfg, x: torch.Tensor):
    """The selective parameters of the conv output x [..., di]:
    ``(dt [..., di], B [..., ds], C [..., ds])`` in float32."""
    ds, dtr = cfg.ssm.d_state, dt_rank(cfg)
    proj = x @ p.x_proj
    dt = F.softplus(proj[..., :dtr].float() @ p.dt_proj + p.dt_bias)
    return (dt, proj[..., dtr:dtr + ds].float(),
            proj[..., dtr + ds:].float())


def _in_proj(p: Mamba, cfg, x: torch.Tensor):
    """``x @ in_proj`` [B,S,2 di] as its x and z halves.  On DTensors
    each half is its own product with its columns of the weight, the
    halves laid out as the residual stream (the weight's slice gathers
    the columns, a weight's bytes): a slice of the product, sharded over
    ``"model"`` across the halves' boundary, would gather the whole
    ``[B, S, 2 di]`` product instead."""
    di = cfg.d_inner
    if shardctx.is_distributed(x):
        return tuple(shardctx.hint(x @ w, shardctx.DP, None, shardctx.TP)
                     for w in (p.in_proj[:, :di], p.in_proj[:, di:]))
    xz = x @ p.in_proj
    return xz[..., :di], xz[..., di:]


def _ssm_inputs(p: Mamba, cfg, x: torch.Tensor, z: torch.Tensor):
    """The common front half: the causal depthwise conv over time, silu,
    and the selective parameters.  x, z: [B,S,di], ``_in_proj``'s
    halves."""
    dc = cfg.ssm.d_conv
    s = x.shape[1]
    pads = F.pad(x, (0, 0, dc - 1, 0))
    x = sum(pads[:, i:i + s] * p.conv_w[i] for i in range(dc)) + p.conv_b
    x = F.silu(x)
    return (x, z) + _selective(p, cfg, x)


def scan_chunk(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``(a, b)`` along dim 1 under ``(a, b) o (a', b') =
    (a a', a' b + b')``, Hillis-Steele: after the round at offset ``o``
    each step holds the composition of the ``2 o`` steps ending at it.
    Returns ``(a, b)``: the products of a, and the states from a zero
    start.  Each round builds new tensors (the first ``o`` steps kept,
    the rest combined), so autograd can go through it; the products and
    adds are those of an in-place round, in the same order."""
    c = a.shape[1]
    for r in range(math.ceil(math.log2(c)) if c > 1 else 0):
        o = 1 << r
        b = torch.cat([b[:, :o], b[:, o:] + b[:, :-o] * a[:, o:]], dim=1)
        a = torch.cat([a[:, :o], a[:, :-o] * a[:, o:]], dim=1)
    return a, b


def _scan_block(a, h, dtk, xk, bk, ck):
    """One chunk: discretise, scan, inject the carry ``h`` [B, di, ds].
    Returns ``(h at the chunk's last step, y [B, c, di])``."""
    da = torch.exp(dtk[..., None] * a)                       # [B,c,di,ds]
    dbx = (dtk * xk)[..., None] * bk[:, :, None, :]
    aa, hh = scan_chunk(da, dbx)
    hh = hh + aa * h[:, None]                                # the carry
    return hh[:, -1].clone(), torch.einsum("bcdn,bcn->bcd", hh, ck)


def apply_train(p: Mamba, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d]; the chunked selective scan.  Where
    autograd records, each chunk runs under a checkpoint, as the
    reference checkpoints its chunk body: backward then holds one
    chunk's ``[B, c, di, ds]`` rounds at a time, not every chunk's."""
    xc, z, dt, bmat, cmat = _ssm_inputs(p, cfg, *_in_proj(p, cfg, x))
    a = -torch.exp(p.A_log)                                  # [di, ds]
    xf = xc.float()
    if shardctx.is_distributed(xf):
        y = local_rules.by_channels(
            lambda *t: torch.cat(_scan(*t)[1], dim=1), a, dt, xf, bmat, cmat)
    else:
        # the last state and the chunks stay live to the end, as they
        # always have (the one-card dry run's peak counts them)
        h, ys = _scan(a, dt, xf, bmat, cmat)
        y = torch.cat(ys, dim=1)
    y = y + xf * p.D
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ p.out_proj


def _scan(a, dt, xf, bmat, cmat):
    """The chunked scan from a zero state: ``(h, ys)``, the last state
    [B, di, ds] and the chunks' outputs [B, c, di] (no skip term)."""
    b, s, di = xf.shape
    h = torch.zeros((b, di, a.shape[1]), dtype=torch.float32,
                    device=xf.device)
    block = _scan_block
    if torch.is_grad_enabled():
        block = functools.partial(checkpoint, _scan_block,
                                  use_reentrant=False)
    ys = []
    for c0 in range(0, s, _CHUNK):
        sl = slice(c0, c0 + _CHUNK)
        h, yk = block(a, h, dt[:, sl], xf[:, sl], bmat[:, sl], cmat[:, sl])
        ys.append(yk)
    return h, ys


def init_decode_state(cfg, batch: int, device=None) -> dict:
    """``{"h": float32 [B, di, ds], "conv": bfloat16 [B, d_conv - 1, di]}``,
    zeros."""
    di = cfg.d_inner
    return {"h": torch.zeros((batch, di, cfg.ssm.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, di),
                                dtype=torch.bfloat16, device=device)}


def apply_decode(p: Mamba, cfg, x: torch.Tensor,
                 state: dict) -> torch.Tensor:
    """x: [B, 1, d]; the O(1) recurrent step.  ``state`` (``h`` and
    ``conv``, e.g. one layer's rows of the serving state) is updated in
    place.  Returns y [B, 1, d]."""
    di, dc = cfg.d_inner, cfg.ssm.d_conv
    xz = x @ p.in_proj                                       # [B,1,2di]
    xr, z = xz[..., :di], xz[..., di:]
    hist = torch.cat([state["conv"].to(xr.dtype), xr], dim=1)  # [B,dc,di]
    xc = sum(hist[:, i] * p.conv_w[i] for i in range(dc)) + p.conv_b
    xc = F.silu(xc)                                          # [B,di]
    dt, bm, cm = _selective(p, cfg, xc)
    da = torch.exp(dt[..., None] * -torch.exp(p.A_log))      # [B,di,ds]
    h = state["h"]
    h.mul_(da).add_((dt * xc.float())[..., None] * bm[:, None, :])
    y = torch.einsum("bdn,bn->bd", h, cm) + xc.float() * p.D
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    state["conv"].copy_(hist[:, 1:])
    return (y @ p.out_proj)[:, None]
