"""Training launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --steps 50 --batch 4 --seq 128 [--full] [--ckpt path.npz] \\
        [--device cpu]

``--arch`` is any registered architecture.  Runs on the GPU unless
``--device cpu`` is given.  Without ``--full`` the architecture is its
reduced smoke variant (``ModelConfig.reduced``); ``--full`` is the
published config, for the card only (most do not fit one card whole).
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.optim import adamw
from repro_torch.train import trainer as trainer_lib


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="the published config (card only; default is "
                         "reduced)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.full and device.type != "cuda":
        ap.error("--full runs on the card only")
    cfg = configs.get(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    pc = cfg.param_count()
    print(f"{cfg.name} ({'full' if args.full else 'reduced'}): "
          f"{pc['total'] / 1e6:.1f}M params on {device}")
    tcfg = trainer_lib.TrainerConfig(
        steps=args.steps, batch=args.batch, seq_len=args.seq,
        ckpt_path=args.ckpt,
        opt=adamw.AdamWConfig(lr=args.lr,
                              warmup_steps=max(args.steps // 10, 1),
                              total_steps=args.steps))
    trainer_lib.train(cfg, tcfg, device=device)


if __name__ == "__main__":
    main()
