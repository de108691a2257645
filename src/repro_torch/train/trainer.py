"""The training loop (``repro.train.trainer`` in PyTorch): a fresh
synthetic batch each step, the loss, lr and gradient norm logged, and
the parameters checkpointed in the reference's layout.

The parameters come from ``model.init_params``, drawn from a
``torch.Generator``: a run is not the reference's run from the same
seed (the tests carry the reference's weights across instead).  Its
batches are: ``make_batch`` with seed ``seed * 100003 + step`` draws
the reference's tokens.  A checkpoint holds the stacked ``[L, ...]``
leaves under the reference's ``::`` keys (``layers::mix::wq``), so
either package's ``checkpoint.restore`` reads the other's file.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.steps import make_train_step, param_dict


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 128
    log_every: int = 10
    ckpt_every: int = 0            # 0 = only final
    ckpt_path: str = ""
    seed: int = 0
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)


def _nest(flat: dict) -> dict:
    """``{"layers.mix.wq": t}`` -> ``{"layers": {"mix": {"wq": t}}}``."""
    tree: dict = {}
    for key, leaf in flat.items():
        *path, last = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def save_params(path: str, params: model_lib.Model, cfg: ModelConfig,
                step: int | None = None) -> None:
    """A checkpoint of ``params`` in the reference's layout."""
    ckpt_lib.save(path, _nest(interop.params_to_arrays(params, cfg)),
                  step=step)


def restore_params(path: str, cfg: ModelConfig, dtype=torch.bfloat16,
                   device=None) -> tuple[model_lib.Model, int | None]:
    """A ``Model`` in ``dtype`` on ``device`` (the GPU unless
    ``device="cpu"``) from a checkpoint in the reference's layout,
    written by either package; and its step."""
    device = resolve_device(device)
    like = interop.params_to_arrays(
        model_lib.Model(cfg, dtype=dtype, device="cpu"), cfg)
    tree, step = ckpt_lib.restore(path, _nest(like))
    flat = dict(ckpt_lib.flat_items(tree))
    flat = {k.replace("::", "."): v for k, v in flat.items()}
    return interop.params_from_arrays(flat, cfg, device=device), step


def train(cfg: ModelConfig, tcfg: TrainerConfig, device=None):
    """Train from ``init_params(seed=tcfg.seed)`` (bf16) on ``device``
    (the GPU unless ``device="cpu"``).  Returns ``(params, opt_state,
    history)``, history the ``(step, loss)`` of each logged step."""
    device = resolve_device(device)
    params = model_lib.init_params(cfg, seed=tcfg.seed, device=device)
    opt_state = adamw.init(param_dict(params))
    step_fn = make_train_step(cfg, tcfg.opt)
    history = []
    t0 = time.time()
    for step in range(tcfg.steps):
        batch = pipeline.make_batch(cfg, tcfg.batch, tcfg.seq_len,
                                    seed=tcfg.seed * 100003 + step,
                                    device=device)
        params, opt_state, mets = step_fn(params, opt_state, batch)
        if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
            loss = float(mets["loss"])
            history.append((step, loss))
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"lr {float(mets['lr']):.2e} "
                  f"gnorm {float(mets['grad_norm']):.3f} "
                  f"({time.time() - t0:.1f}s)")
        if tcfg.ckpt_every and step and step % tcfg.ckpt_every == 0 \
                and tcfg.ckpt_path:
            save_params(tcfg.ckpt_path, params, cfg, step=step)
    if tcfg.ckpt_path:
        save_params(tcfg.ckpt_path, params, cfg, step=tcfg.steps)
    return params, opt_state, history
