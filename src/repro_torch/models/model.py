"""The dense decoder family (``repro.models.model`` in PyTorch): the
parameters as ``nn.Module``s, one ``Layer`` per decoder layer in a
``ModuleList``, and ``prefill``, the inference forward that returns the
last token's logits.

The reference stacks the layers' parameters on a leading axis and scans
over them; here the layers are a Python loop over modules, which is the
same computation.  The reference's sharding hints (``_hint``,
``shardctx.residual_hint``) are no-ops on one device and are left out.
Only ``arch_type == "dense"`` is ported; the other families raise
``NotImplementedError`` naming their ROADMAP item, and the training
forward and its loss wait for the training slice.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention
from repro_torch.models.layers import (act_fn, embed_init, linear_init,
                                       rmsnorm, rmsnorm_init)

_NOT_PORTED = {
    "moe": "the MoE family (ROADMAP A12: models/moe.py)",
    "ssm": "the SSM family (ROADMAP A12: models/mamba.py)",
    "hybrid": "the hybrid attention/SSM family (ROADMAP A12)",
    "vlm": "the vision-language family (ROADMAP A12)",
    "audio": "the encoder-decoder audio family (ROADMAP A12)",
}


def check_family(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is of the one family the port runs."""
    if cfg.arch_type != "dense":
        what = _NOT_PORTED.get(cfg.arch_type)
        if what is None:
            raise ValueError(cfg.arch_type)
        raise NotImplementedError(f"{cfg.name}: {what} is not ported yet; "
                                  "the port runs the dense family")


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
    """One decoder layer (the reference's ``init_layer`` with attention and
    a dense MLP): ``norm1``, ``mix``, and ``norm2`` / ``ffn`` where the
    config has an MLP."""

    def __init__(self, cfg, gen=None, dtype=torch.bfloat16, device=None):
        super().__init__()
        dev = gen.device if gen is not None else device
        self.norm1 = _param(rmsnorm_init(cfg.d_model, dev))
        self.mix = attention.Attention(cfg, gen, dtype, dev)
        self.norm2 = self.ffn = None
        if cfg.d_ff:
            self.norm2 = _param(rmsnorm_init(cfg.d_model, dev))
            self.ffn = MLP(cfg, gen, dtype, dev)


class Model(nn.Module):
    """The parameters of a dense decoder (the reference's ``init_params``
    pytree): ``embed`` and, unless tied, ``out`` ``[vocab_padded, d]``,
    ``final_norm``, and ``layers``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator | None = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        check_family(cfg)
        dev = gen.device if gen is not None else device
        vp = vocab_padded(cfg)

        def embed():
            if gen is not None:
                return _param(embed_init(gen, vp, cfg.d_model, dtype))
            return _param(torch.empty((vp, cfg.d_model), dtype=dtype,
                                      device=dev))
        self.embed = embed()
        self.final_norm = _param(rmsnorm_init(cfg.d_model, dev))
        self.out = None if cfg.tie_embeddings else embed()
        self.layers = nn.ModuleList(Layer(cfg, gen, dtype, dev)
                                    for _ in range(cfg.n_layers))


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> Model:
    """Random parameters on ``device`` (the GPU unless ``device="cpu"``),
    drawn from a ``torch.Generator`` on that device seeded with ``seed``,
    with the reference's distributions and scales."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return Model(cfg, gen, dtype, device)


# ----------------------------------------------------------------------
# Forward (prefill)
# ----------------------------------------------------------------------

def _layer_apply(p: Layer, cfg, x: torch.Tensor, positions,
                 causal: bool = True) -> torch.Tensor:
    h = rmsnorm(x, p.norm1, cfg.norm_eps)
    x = x + attention.self_attention(p.mix, cfg, h, positions, causal=causal)
    if p.ffn is not None:
        h2 = rmsnorm(x, p.norm2, cfg.norm_eps)
        x = x + _mlp_apply(p.ffn, cfg, h2)
    return x


def _run_stack(layers: nn.ModuleList, cfg, x: torch.Tensor, positions,
               causal: bool = True) -> torch.Tensor:
    for lp in layers:
        x = _layer_apply(lp, cfg, x, positions, causal)
    return x


def _logits(params: Model, cfg, x: torch.Tensor) -> torch.Tensor:
    """float32 logits over the padded vocabulary; the padding rows are
    masked to -1e9."""
    out = params.out if params.out is not None else params.embed
    logits = torch.einsum("bsd,vd->bsv", x, out).float()
    vp = vocab_padded(cfg)
    if vp != cfg.vocab:
        real = torch.arange(vp, device=logits.device) < cfg.vocab
        logits = torch.where(real, logits, -1e9)
    return logits


def _embed_tokens(params: Model, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens.long()]


@torch.no_grad()
def prefill(params: Model, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Inference prefill: the forward without a loss; returns the last
    token's logits [B, vocab_padded].  ``batch["tokens"]``: [B, S] on the
    parameters' device."""
    check_family(cfg)
    x = _embed_tokens(params, cfg, batch["tokens"])
    pos = torch.arange(x.shape[1], device=x.device)[None]
    x = _run_stack(params.layers, cfg, x, pos)
    x = rmsnorm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0]
