"""Every model family of the reference (``repro.models.model`` in
PyTorch): the parameters as ``nn.Module`` trees, and ``prefill``, the
inference forward that returns the last token's logits.

Families:
  dense / moe   uniform decoder layers (attention + MLP or MoE)
  ssm           uniform Mamba-1 layers (no attention, no MLP)
  hybrid        periods of ``attn_every`` layers, attention at position
                0 and Mamba elsewhere, MoE where ``cfg.is_moe_layer(j)``;
                one stack a position (``layers.l<j>``, one layer a period)
  vlm           the dense decoder over [projected patch embeddings;
                token embeddings] (the vision frontend is a stub)
  audio         a bidirectional encoder over frame embeddings (stub
                frontend) and a causal decoder with cross-attention

The reference stacks the layers' parameters on a leading axis and scans
over them; here each stack is a ``ModuleList`` and the scan a Python
loop, which is the same computation.  The reference's sharding hints
stand where it has them (``launch.shardctx``: the residual stream at
each layer's entry and exit, the output embedding and the logits); they
act on DTensors only, so on one device they add no op.  ``forward`` is the
training forward and its loss; ``trainable`` turns the parameters'
gradients on for a step.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import local_rules, shardctx
from repro_torch.models import attention, mamba, moe
from repro_torch.models.layers import (act_fn, embed_init, linear_init,
                                       rmsnorm, rmsnorm_init)


def vocab_padded(cfg: ModelConfig) -> int:
    """Pad vocab to a multiple of 512 (MaxText-style logit padding)."""
    return -(-cfg.vocab // 512) * 512


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _linear(gen, d_in, d_out, dtype, device):
    if gen is not None:
        return _param(linear_init(gen, d_in, d_out, dtype))
    return _param(torch.empty((d_in, d_out), dtype=dtype, device=device))


class MLP(nn.Module):
    """The gated MLP (the reference's ``_mlp_init``)."""

    def __init__(self, cfg, gen=None, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.w_gate = _linear(gen, cfg.d_model, cfg.d_ff, dtype, device)
        self.w_up = _linear(gen, cfg.d_model, cfg.d_ff, dtype, device)
        self.w_down = _linear(gen, cfg.d_ff, cfg.d_model, dtype, device)


def _mlp_apply(p: MLP, cfg, x: torch.Tensor) -> torch.Tensor:
    a = act_fn(cfg.act)
    return (a(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


class Layer(nn.Module):
    """One layer (the reference's ``init_layer``): ``norm1`` and ``mix``
    (``Attention``, or ``Mamba`` where ``attn`` is false); with ``cross``
    (the audio decoder) ``norm_x`` and the cross-attention ``cross``; and
    ``norm2`` / ``ffn``, a ``MoE`` where ``moe_layer``, else an ``MLP``
    where the config has one."""

    def __init__(self, cfg, attn: bool = True, moe_layer: bool = False,
                 cross: bool = False, gen=None, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        dev = gen.device if gen is not None else device
        self.norm1 = _param(rmsnorm_init(cfg.d_model, dev))
        self.mix = (attention.Attention(cfg, gen, dtype, dev) if attn
                    else mamba.Mamba(cfg, gen, dtype, dev))
        self.norm_x = self.cross = None
        if cross:
            self.norm_x = _param(rmsnorm_init(cfg.d_model, dev))
            self.cross = attention.cross_attention_init(cfg, gen, dtype, dev)
        self.norm2 = self.ffn = None
        if moe_layer or cfg.d_ff:
            self.norm2 = _param(rmsnorm_init(cfg.d_model, dev))
            self.ffn = (moe.MoE(cfg, gen, dtype, dev) if moe_layer
                        else MLP(cfg, gen, dtype, dev))


class Projector(nn.Module):
    """The vlm's patch projector: ``gelu(patches @ w1) @ w2``."""

    def __init__(self, cfg, gen=None, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.w1 = _linear(gen, cfg.d_model, cfg.d_model, dtype, device)
        self.w2 = _linear(gen, cfg.d_model, cfg.d_model, dtype, device)


class Model(nn.Module):
    """A model's parameters (the reference's ``init_params`` pytree):
    ``embed`` and, unless tied, ``out`` ``[vocab_padded, d]``,
    ``final_norm``, and ``layers``: a ``ModuleList`` of ``Layer``s, or
    for the hybrid a ``ModuleDict`` of one ``ModuleList`` a period
    position (``l0`` ... ``l<period-1>``, ``n_layers / period`` layers
    each).  The audio family adds ``enc_layers`` and ``enc_norm``, the
    vlm ``projector``.  An unknown ``arch_type`` raises ``ValueError``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        dev = gen.device if gen is not None else device
        vp = vocab_padded(cfg)

        def embed():
            if gen is not None:
                return _param(embed_init(gen, vp, cfg.d_model, dtype))
            return _param(torch.empty((vp, cfg.d_model), dtype=dtype,
                                      device=dev))

        def stack(n, attn, moe_layer, cross=False):
            return nn.ModuleList(Layer(cfg, attn, moe_layer, cross, gen,
                                       dtype, dev) for _ in range(n))
        self.embed = embed()
        self.final_norm = _param(rmsnorm_init(cfg.d_model, dev))
        self.out = None if cfg.tie_embeddings else embed()
        kind = cfg.arch_type
        if kind in ("dense", "vlm", "moe", "ssm"):
            self.layers = stack(cfg.n_layers, kind != "ssm", kind == "moe")
        elif kind == "hybrid":
            period = cfg.attn_every
            self.layers = nn.ModuleDict({
                f"l{j}": stack(cfg.n_layers // period, j % period == 0,
                               cfg.is_moe_layer(j))
                for j in range(period)})
        elif kind == "audio":
            self.enc_layers = stack(cfg.n_enc_layers, True, False)
            self.enc_norm = _param(rmsnorm_init(cfg.d_model, dev))
            self.layers = stack(cfg.n_layers, True, False, cross=True)
        else:
            raise ValueError(cfg.arch_type)
        if kind == "vlm":
            self.projector = Projector(cfg, gen, dtype, dev)


def hybrid_layers(params: Model, cfg) -> list[tuple[int, int, Layer]]:
    """The hybrid's layers in depth order as ``(period, position,
    layer)``: layer ``period * attn_every + position``."""
    return [(p, j, params.layers[f"l{j}"][p])
            for p in range(cfg.n_layers // cfg.attn_every)
            for j in range(cfg.attn_every)]


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> Model:
    """Random parameters on ``device`` (the GPU unless ``device="cpu"``),
    drawn from a ``torch.Generator`` on that device seeded with ``seed``,
    with the reference's distributions and scales."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return Model(cfg, gen, dtype, device)


@contextlib.contextmanager
def trainable(params: Model):
    """Inside the block every parameter of ``params`` records gradients;
    on exit each gets back the flag it had.  The parameters are built
    with ``requires_grad=False``, which serving keeps: ``prefill`` and
    ``decode_step`` run under ``torch.no_grad`` either way."""
    saved = [(p, p.requires_grad) for p in params.parameters()]
    for p, _ in saved:
        p.requires_grad_(True)
    try:
        yield params
    finally:
        for p, flag in saved:
            p.requires_grad_(flag)


# ----------------------------------------------------------------------
# Forward (training and prefill)
# ----------------------------------------------------------------------

def _layer_apply(p: Layer, cfg, x: torch.Tensor, positions,
                 causal: bool = True, mem: torch.Tensor | None = None):
    """One layer over [B,S,d]; ``mem`` [B,T,d], the encoder output, for
    the audio decoder's cross-attention (all of it valid).  Returns
    ``(x, aux)``, aux the MoE's load-balance loss (0 without one)."""
    x = shardctx.residual_hint(x)
    h = rmsnorm(x, p.norm1, cfg.norm_eps)
    if isinstance(p.mix, attention.Attention):
        x = x + attention.self_attention(p.mix, cfg, h, positions,
                                         causal=causal)
    else:
        x = x + mamba.apply_train(p.mix, cfg, h)
    if mem is not None:
        hx = rmsnorm(x, p.norm_x, cfg.norm_eps)
        mk, mv = attention.mem_kv(p.cross, cfg, mem)
        mmask = torch.ones(mem.shape[:2], dtype=torch.bool, device=x.device)
        x = x + attention.cross_attention(p.cross, cfg, hx, mk, mv, mmask)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if p.ffn is not None:
        h2 = rmsnorm(x, p.norm2, cfg.norm_eps)
        if isinstance(p.ffn, moe.MoE):
            y, aux = moe.apply(p.ffn, cfg, h2)
        else:
            y = _mlp_apply(p.ffn, cfg, h2)
        x = x + y
    return shardctx.residual_hint(x), aux


def _layer_remat(lp: Layer, cfg, x, positions, causal=True, mem=None,
                 remat: bool = True):
    """``_layer_apply``, under a checkpoint where ``remat`` is set and
    autograd records: backward recomputes the layer from its input and
    keeps none of its activations, the counterpart of the reference's
    ``jax.checkpoint(policy=nothing_saveable)``."""
    if remat and torch.is_grad_enabled():
        return checkpoint(_layer_apply, lp, cfg, x, positions, causal, mem,
                          use_reentrant=False)
    return _layer_apply(lp, cfg, x, positions, causal, mem)


def _run_stack(layers: nn.ModuleList, cfg, x: torch.Tensor, positions,
               causal: bool = True, mem: torch.Tensor | None = None,
               remat: bool = True):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layers:
        x, a = _layer_remat(lp, cfg, x, positions, causal, mem, remat)
        aux = aux + a
    return x, aux


def _run_hybrid(params: Model, cfg, x: torch.Tensor, positions,
                remat: bool = True):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, _, lp in hybrid_layers(params, cfg):
        x, a = _layer_remat(lp, cfg, x, positions, remat=remat)
        aux = aux + a
    return x, aux


def _trunk(params: Model, cfg, x: torch.Tensor, positions,
           mem: torch.Tensor | None = None, remat: bool = True):
    if cfg.arch_type == "hybrid":
        return _run_hybrid(params, cfg, x, positions, remat)
    return _run_stack(params.layers, cfg, x, positions, causal=True, mem=mem,
                      remat=remat)


def _logits(params: Model, cfg, x: torch.Tensor) -> torch.Tensor:
    """float32 logits over the padded vocabulary; the padding rows are
    masked to -1e9."""
    out = params.out if params.out is not None else params.embed
    # the output embedding's FSDP-sharded d gathered, not the [B, S, V]
    # partial logits reduced over the data axis (the reference's hints);
    # on DTensors x is gathered whole over d too, so each rank's logits
    # are its vocabulary block (the layout XLA derives from the hints)
    out = shardctx.hint(out, shardctx.TP, None)
    x = shardctx.hint(x, shardctx.DP, None, None)
    logits = torch.einsum("bsd,vd->bsv", x, out).float()
    logits = shardctx.hint(logits, shardctx.DP, None, shardctx.TP)
    vp = vocab_padded(cfg)
    if vp != cfg.vocab:
        real = torch.arange(vp, device=logits.device) < cfg.vocab
        logits = torch.where(real, logits, -1e9)
    return logits


def _embed_tokens(params: Model, cfg, tokens: torch.Tensor) -> torch.Tensor:
    if shardctx.is_distributed(params.embed):
        return shardctx.residual_hint(
            local_rules.vocab_embedding(params.embed, tokens))
    return params.embed[tokens.long()]


def _encode(params: Model, cfg, frames: torch.Tensor,
            remat: bool = True) -> torch.Tensor:
    """The audio encoder: bidirectional self-attention over the frames
    [B,T,d], then ``enc_norm``.  Frames in bfloat16 meet a float32
    model's weights in float32 (the reference's scan refuses that
    model's prefill: its carry would change dtype)."""
    frames = frames.to(torch.promote_types(frames.dtype,
                                           params.embed.dtype))
    pos = torch.arange(frames.shape[1], device=frames.device)[None]
    x, _ = _run_stack(params.enc_layers, cfg, frames, pos, causal=False,
                      remat=remat)
    return rmsnorm(x, params.enc_norm, cfg.norm_eps)


def _project_patches(params: Model, patches: torch.Tensor) -> torch.Tensor:
    """The vlm projector over patch embeddings taken in bfloat16 (as the
    reference), promoted to the weights' dtype."""
    pr = params.projector
    x = patches.to(torch.bfloat16).to(torch.promote_types(torch.bfloat16,
                                                          pr.w1.dtype))
    return act_fn("gelu")(x @ pr.w1) @ pr.w2


def _inputs(params: Model, cfg, batch: dict, remat: bool):
    """The trunk's input [B, P + S, d] (P projected patches for the vlm,
    else 0), its positions, the audio encoder's memory (or None) and
    P.  Frames and patches are taken in bfloat16, as the reference
    takes them."""
    x = _embed_tokens(params, cfg, batch["tokens"])
    mem, n_front = None, 0
    if cfg.arch_type == "audio":
        mem = _encode(params, cfg, batch["frames"].to(torch.bfloat16), remat)
    elif cfg.arch_type == "vlm":
        patches = _project_patches(params, batch["patches"])
        n_front = patches.shape[1]
        x = torch.cat([patches, x], dim=1)
    pos = torch.arange(x.shape[1], device=x.device)[None]
    return x, pos, mem, n_front


def hidden(params: Model, cfg: ModelConfig, batch: dict,
           remat: bool = True):
    """The training forward's trunk: ``(x [B, S, d], aux)``, x the
    final-normed states of the text positions (the vlm's patch positions
    dropped) and aux the summed MoE load-balance loss."""
    x, pos, mem, n_front = _inputs(params, cfg, batch, remat)
    x, aux = _trunk(params, cfg, x, pos, mem=mem, remat=remat)
    return rmsnorm(x[:, n_front:], params.final_norm, cfg.norm_eps), aux


def token_nll(params: Model, cfg: ModelConfig, x: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """The mean over every position of ``logsumexp(logits) -
    logits[label]``, the logits float32 over ``vocab_padded`` with the
    padding rows at -1e9.  The label's logit is gathered: the
    reference contracts the logits with a one-hot of the label, a sum
    of that one logit and zeros, which is the same number, and a
    ``[B, S, V]`` one-hot is never built."""
    logits = _logits(params, cfg, x)
    if shardctx.is_distributed(logits):
        lse = local_rules.vocab_logsumexp(logits)
    else:
        lse = torch.logsumexp(logits, dim=-1)
    if shardctx.is_distributed(logits):
        label_logit = local_rules.label_logits(logits, labels)
    else:
        label_logit = torch.gather(logits, -1,
                                   labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    return nll.sum() / max(nll.numel(), 1)


def forward(params: Model, cfg: ModelConfig, batch: dict,
            remat: bool = True):
    """The training forward: ``(loss, {"nll": ..., "aux": ...})``.
    ``batch`` holds ``tokens`` and ``labels`` [B, S], plus ``frames``
    (audio) or ``patches`` (vlm) as ``data.pipeline.make_batch`` makes
    them.  The loss is the token nll over the text positions plus 0.01
    times the MoE load-balance loss where the config has MoE.  With
    ``remat`` each layer is recomputed in backward (``_layer_remat``).
    Autograd records only where the parameters ask for gradients
    (``trainable``)."""
    x, aux = hidden(params, cfg, batch, remat)
    nll = token_nll(params, cfg, x, batch["labels"])
    aux_w = 0.01 if cfg.moe is not None else 0.0
    return nll + aux_w * aux, {"nll": nll, "aux": aux}


@torch.no_grad()
def prefill(params: Model, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Inference prefill: the forward without a loss; returns the last
    token's logits [B, vocab_padded].  ``batch`` holds ``tokens`` [B, S],
    plus ``frames`` [B, T, d] (audio) or ``patches`` [B, P, d] (vlm), on
    the parameters' device; frames and patches are taken in bfloat16, as
    the reference takes them."""
    x, pos, mem, _ = _inputs(params, cfg, batch, remat=True)
    x, _ = _trunk(params, cfg, x, pos, mem=mem)
    x = rmsnorm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0]
