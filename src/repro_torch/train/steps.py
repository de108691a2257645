"""Training and serving step functions (``repro.train.steps`` in
PyTorch)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.serve import engine as serve_engine


def param_dict(params: model_lib.Model) -> dict:
    """A model's parameters as the tree ``optim.adamw`` takes: name ->
    tensor, detached (the same storage)."""
    return {n: p.detach() for n, p in params.named_parameters()}


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "nll", "aux", "grad_norm", "lr"})``: the gradient of
    ``model.forward``'s loss (each layer recomputed in backward) and one
    AdamW update (``adamw.update_``).  The new values are written into
    ``params`` and ``opt_state``, which are returned; the metrics are
    scalar tensors on its device."""
    def train_step(params, opt_state, batch):
        named = list(params.named_parameters())
        with model_lib.trainable(params):
            loss, mets = model_lib.forward(params, cfg, batch, remat=True)
            grads = torch.autograd.grad(loss, [p for _, p in named],
                                        allow_unused=True,
                                        materialize_grads=True)
        with torch.no_grad():
            opt_state, opt_mets = adamw.update_(
                opt_cfg, {n: g for (n, _), g in zip(named, grads)},
                opt_state, param_dict(params))
        return params, opt_state, {"loss": loss.detach(),
                                   "nll": mets["nll"].detach(),
                                   "aux": mets["aux"].detach(), **opt_mets}
    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return model_lib.prefill(params, cfg, batch)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, token, state):
        return serve_engine.decode_step(params, cfg, token, state)
    return serve_step
