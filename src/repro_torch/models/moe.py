"""Mixture-of-Experts layer with sort-based dispatch (``repro.models.moe``
in PyTorch).

Each token's top-k experts are sorted (stably, as ``jnp.argsort``), a
token's position within its expert comes from ``searchsorted`` over the
sorted expert ids, and the tokens are scattered into a capacity buffer
``[G, E, cap, d]``, dropping those past ``cap``.  The expert FFN is
three batched products over the expert axis, and the combine gathers
each kept assignment's output and weights it by its renormalised gate.

Grouping follows the reference: one group a batch row for prefill
shapes, and the whole batch as one group at decode (``S == 1``), so the
capacity and the drops are those of that grouping.  The groups are
vectorised rather than looped.  The four steps are module-level
functions (``route``, ``dispatch``, ``expert_ffn``, ``combine``), so a
profile can time each.  On DTensors the buffer carries the reference's
two hints (experts over ``"model"`` for the FFN, then d for the
combine), and the expert counts, the dispatch and the expert FFN run on
the local shards (``launch.local_rules``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.launch import local_rules, shardctx
from repro_torch.models.layers import act_fn, linear_init


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class MoE(nn.Module):
    """One MoE layer's weights: ``router`` float32 ``[d, E]``, ``w_gate``
    and ``w_up`` ``[E, d, dff]``, ``w_down`` ``[E, dff, d]``.  With
    ``gen`` they are drawn as the reference draws them (the router
    Glorot-normal; the experts a float32 normal times ``sqrt(2 / (d +
    dff))``, then cast); without, left uninitialised on ``device``."""

    def __init__(self, cfg, gen: torch.Generator | None = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        m = cfg.moe
        d, dff, e = cfg.d_model, m.d_ff_expert, m.n_experts
        scale_in = (2.0 / (d + dff)) ** 0.5

        def expert(shape):
            if gen is None:
                return _param(torch.empty(shape, dtype=dtype, device=device))
            w = torch.randn(shape, generator=gen, device=gen.device,
                            dtype=torch.float32)
            return _param(w.mul_(scale_in).to(dtype))
        self.router = _param(
            linear_init(gen, d, e, torch.float32) if gen is not None
            else torch.empty((d, e), dtype=torch.float32, device=device))
        self.w_gate = expert((e, d, dff))
        self.w_up = expert((e, d, dff))
        self.w_down = expert((e, dff, d))


def capacity(cfg, s: int) -> int:
    """Slots an expert has in a group of ``s`` tokens (the reference's
    float arithmetic)."""
    m = cfg.moe
    return int(max(1, min(s, (s * m.top_k * m.capacity_factor)
                          // m.n_experts + 1)))


def route(p: MoE, cfg, x: torch.Tensor):
    """The float32 router: ``(logits [G,S,E], gate [G,S,k] renormalised,
    eidx [G,S,k], aux)``, aux the load-balance loss ``E * sum_e f_e p_e``."""
    m = cfg.moe
    b, s = x.shape[:2]
    logits = x.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, m.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))
    # counts by a scatter-add, as the reference: bincount on CUDA would
    # wait for the device to size its output
    if shardctx.is_distributed(eidx):
        ce = local_rules.expert_counts(eidx, m.n_experts)
    else:
        flat = eidx.reshape(-1)
        ce = torch.zeros(m.n_experts, dtype=torch.float32,
                         device=x.device).index_add_(
            0, flat, torch.ones(flat.shape, device=x.device))
    ce = ce / (b * s * m.top_k)
    aux = m.n_experts * (me * ce).sum()
    return logits, gate, eidx, aux


def dispatch(x: torch.Tensor, eidx: torch.Tensor, n_experts: int, cap: int):
    """Sort-based dispatch of each group: x [G,S,d], eidx [G,S,k] ->
    ``(buf [G,E,cap,d], pos [G,S*k], keep [G,S*k])``, ``pos`` each
    assignment's place in its expert (in token-major order) and ``keep``
    whether it is below ``cap``.  The sort is stable, so the earlier
    assignment wins a slot, as in the reference."""
    g, s, d = x.shape
    k = eidx.shape[-1]
    flat_e = eidx.reshape(g, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(n_experts, device=x.device).expand(g, n_experts)
    start = torch.searchsorted(sorted_e, experts.contiguous())
    pos_sorted = (torch.arange(s * k, device=x.device)
                  - torch.gather(start, 1, sorted_e))
    keep_sorted = pos_sorted < cap
    # dropped assignments go to a spare row past the buffer
    dest = torch.where(keep_sorted, sorted_e * cap + pos_sorted,
                       n_experts * cap)
    rows = torch.gather(x, 1, (order // k)[..., None].expand(g, s * k, d))
    buf = x.new_zeros((g, n_experts * cap + 1, d))
    buf.scatter_(1, dest[..., None].expand(g, s * k, d), rows)
    buf = buf[:, :n_experts * cap].reshape(g, n_experts, cap, d)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    return buf, pos, pos < cap


def expert_ffn(p: MoE, cfg, buf: torch.Tensor) -> torch.Tensor:
    """The gated FFN of every expert over its slots: [G,E,cap,d]."""
    return _expert_ffn(cfg, buf, p.w_gate, p.w_up, p.w_down)


def _expert_ffn(cfg, buf, w_gate, w_up, w_down):
    act = act_fn(cfg.act)
    h = act(torch.einsum("becd,edf->becf", buf, w_gate)) \
        * torch.einsum("becd,edf->becf", buf, w_up)
    return torch.einsum("becf,efd->becd", h, w_down)


def combine(out_buf: torch.Tensor, eidx: torch.Tensor, pos: torch.Tensor,
            keep: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Each token's kept assignments' outputs weighted by their gates (in
    the outputs' dtype) and summed: [G,S,d]."""
    g, n_experts, cap, d = out_buf.shape
    s, k = eidx.shape[1:]
    idx = eidx.reshape(g, s * k) * cap + pos.clamp(0, cap - 1)
    contrib = torch.gather(out_buf.reshape(g, n_experts * cap, d), 1,
                           idx[..., None].expand(g, s * k, d))
    contrib = torch.where(keep[..., None], contrib, 0)
    return (contrib.reshape(g, s, k, d)
            * gate[..., None].to(out_buf.dtype)).sum(dim=2)


def apply(p: MoE, cfg, x: torch.Tensor):
    """x: [B, S, d] -> (y [B, S, d], aux scalar).  A group is a batch row,
    or the whole batch when ``S == 1`` (decode)."""
    b0, s0, d = x.shape
    if s0 == 1:
        x = x.reshape(1, b0, d)
    _, gate, eidx, aux = route(p, cfg, x)
    n_e, cap = cfg.moe.n_experts, capacity(cfg, x.shape[1])
    if shardctx.is_distributed(x):
        buf, pos, keep = local_rules.by_group(
            lambda xl, el: dispatch(xl, el, n_e, cap), 3, x, eidx)
    else:
        buf, pos, keep = dispatch(x, eidx, n_e, cap)
    # experts over the model axis for the FFN, then d over it for the
    # combine's gathers (the reference's hints)
    buf = shardctx.hint(buf, shardctx.DP, shardctx.TP, None, None)
    if shardctx.is_distributed(buf):
        out_buf = local_rules.by_expert(
            lambda bl, wg, wu, wd: _expert_ffn(cfg, bl, wg, wu, wd), buf,
            p.w_gate, p.w_up, p.w_down)
    else:
        out_buf = expert_ffn(p, cfg, buf)
    out_buf = shardctx.hint(out_buf, shardctx.DP, None, None, shardctx.TP)
    y = combine(out_buf, eidx, pos, keep, gate)
    return y.reshape(b0, s0, d), aux
