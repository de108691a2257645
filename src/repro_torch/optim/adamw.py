"""AdamW with decoupled weight decay and a warmup-cosine schedule
(``repro.optim.adamw`` in PyTorch), as plain functions on trees of
tensors: a tree is a dict of name -> tensor (``train.steps.param_dict``
of a ``Model``, or any other).

The moments are float32 whatever the parameters' dtype (bf16
parameters and float32 ``m`` / ``v``: 2 + 8 bytes a parameter), and
``step`` is an int32 scalar tensor, so a state interchanges with the
reference's (``interop.opt_state_from_arrays``).  The schedule and the
bias corrections are float32 tensors computed from that step, as JAX
computes them.  The update is written as the reference writes it:
global-norm clipping by ``min(1, clip / (gnorm + 1e-9))``, then
``p - lr * (mh / (sqrt(vh) + eps) + wd * p)`` in float32, cast back to
the parameter's dtype.  ``torch.optim.AdamW`` decays the weights before
the step and arranges its bias correction otherwise: another function.
"""
from __future__ import annotations

import dataclasses
import math

import torch

Tree = dict


@dataclasses.dataclass
class AdamWState:
    m: Tree
    v: Tree
    step: torch.Tensor          # int32 scalar: updates taken


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def init(params: Tree) -> AdamWState:
    """Zero float32 moments shaped as ``params``; step 0 on their
    device."""
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(iter(params.values())).device if params else None
    return AdamWState(m={k: z(p) for k, p in params.items()},
                      v={k: z(p) for k, p in params.items()},
                      step=torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor): linear warmup
    to ``lr``, then a cosine down to ``min_lr_frac * lr`` at
    ``total_steps``; float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaves
    summed in sorted-key order (JAX's order of a dict's leaves)."""
    total = 0
    for k in sorted(tree):
        total = total + torch.sum(torch.square(tree[k].float()))
    return torch.sqrt(total)


def _prepare(cfg: AdamWConfig, grads: Tree, state: AdamWState):
    """The global norm, the clip scale, the next step, its lr and the two
    bias corrections, as float32 tensors."""
    gnorm = global_norm(grads)
    # a tensor over a tensor: torch takes ``float / tensor`` as a
    # reciprocal times the float, another rounding than JAX's divide
    scale = torch.minimum(gnorm.new_tensor(1.0),
                          gnorm.new_tensor(cfg.grad_clip) / (gnorm + 1e-9))
    step = state.step + 1
    return gnorm, scale, step, schedule(cfg, step), (1 - cfg.b1 ** step,
                                                     1 - cfg.b2 ** step)


def _leaf(cfg: AdamWConfig, p, g, m, v, scale, lr, bc):
    """One leaf's ``(new p, m, v)``."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    delta = (m / bc[0]) / (torch.sqrt(v / bc[1]) + cfg.eps) \
        + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m, v


def update(cfg: AdamWConfig, grads: Tree, state: AdamWState, params: Tree):
    """Returns ``(new_params, new_state, {"grad_norm", "lr"})``; the
    inputs are not modified.  ``grad_norm`` is the norm before the
    clip."""
    gnorm, scale, step, lr, bc = _prepare(cfg, grads, state)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        new_p[k], new_m[k], new_v[k] = _leaf(cfg, p, grads[k], state.m[k],
                                             state.v[k], scale, lr, bc)
    return new_p, AdamWState(new_m, new_v, step), {"grad_norm": gnorm,
                                                   "lr": lr}


def update_(cfg: AdamWConfig, grads: Tree, state: AdamWState,
            params: Tree):
    """``update`` written in place, one leaf at a time: each tensor of
    ``params`` takes its new value, and ``state`` its new moments and
    step.  The numbers are ``update``'s; the memory is not: beyond the
    moments it holds one leaf's temporaries, not a second copy of every
    parameter and moment.  Returns ``(state, {"grad_norm", "lr"})``."""
    gnorm, scale, step, lr, bc = _prepare(cfg, grads, state)
    for k, p in params.items():
        new, state.m[k], state.v[k] = _leaf(cfg, p, grads[k], state.m[k],
                                            state.v[k], scale, lr, bc)
        p.copy_(new)
    state.step = step
    return state, {"grad_norm": gnorm, "lr": lr}
