"""Train a ~20M-parameter reduced Qwen3-family model with the PyTorch
port on the synthetic pipeline: the train loop, AdamW, the data
pipeline and the checkpoint end to end (the twin of
``examples/train_lm.py``).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] \\
        [--device cpu]

Runs on the GPU unless ``--device cpu`` is given.  The checkpoint goes
to ``results/torch/lm_ckpt.npz`` (``--ckpt``), in the reference's
layout.
"""
import argparse
import dataclasses

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.optim import adamw
from repro_torch.train import trainer as trainer_lib


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--ckpt", default="results/torch/lm_ckpt.npz")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch).reduced()
    cfg = dataclasses.replace(cfg, n_layers=4, vocab=2048)
    pc = cfg.param_count()
    print(f"training reduced {cfg.name}: {pc['total'] / 1e6:.1f}M params "
          f"on {device}")

    tcfg = trainer_lib.TrainerConfig(
        steps=args.steps, batch=8, seq_len=128, log_every=20,
        ckpt_path=args.ckpt,
        opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=20,
                              total_steps=args.steps))
    params, opt_state, history = trainer_lib.train(cfg, tcfg, device=device)
    first, last = history[0][1], history[-1][1]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
