"""Serving launcher: batched greedy decoding against a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --batch 4 --context 64 --tokens 16 [--full] [--device cpu]

``--arch`` is any of the registered architectures (every family).  Runs
on the GPU unless ``--device cpu`` is given.  Without ``--full`` the
architecture is its reduced smoke variant (``ModelConfig.reduced``).
The parameters are random, drawn on the device from seed 0.  An
encoder-decoder request decodes against the state's cross-attention
memory, which stays zeros here, as in the reference's launcher.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.serve import engine as serve_engine


def _mark(device: torch.device):
    """A point in the device's stream: a recorded CUDA event on the GPU,
    the host clock on the CPU (where every op has finished on return)."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _seconds(marks: list) -> list[float]:
    """The time between consecutive marks, after one wait for the last."""
    if isinstance(marks[0], float):
        return [b - a for a, b in zip(marks, marks[1:])]
    marks[-1].synchronize()
    return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]


def generate(params, cfg, tok: torch.Tensor, state, n_tokens: int):
    """Greedy decoding, as the reference's loop: ``n_tokens`` decode
    steps, the first fed ``tok`` [B, 1], each later one the argmax of the
    previous step's logits over the real vocabulary.  Consumes ``state``.

    Returns ``(tokens [B, n_tokens], logits of the last step, state,
    seconds of each step)``.  The loop never waits for the device: a
    step's time runs from the mark before it to the mark after it in the
    device's stream, and the host waits once, for the last mark."""
    marks = [_mark(tok.device)]
    out = [tok]
    for i in range(n_tokens):
        logits, state = serve_engine.decode_step(params, cfg, tok, state)
        marks.append(_mark(tok.device))
        if i + 1 < n_tokens:
            tok = torch.argmax(logits[:, :cfg.vocab], dim=-1)[:, None].to(
                torch.int32)
            out.append(tok)
    return torch.cat(out, dim=1), logits, state, _seconds(marks)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    params = model_lib.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    state = serve_engine.init_cache(cfg, args.batch, args.context,
                                    device=device)
    tok = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, 1)).astype(np.int32)).to(
            device)
    seqs, _, _, seconds = generate(params, cfg, tok, state, args.tokens)
    # the first step warms up (cuBLAS handles, kernel loading)
    dt = sum(seconds[1:])
    tput = args.batch * (args.tokens - 1) / max(dt, 1e-9)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"{cfg.name}: batch={args.batch} context={args.context} "
          f"-> {args.tokens} tokens/request")
    print(f"throughput {tput:.1f} tok/s on {name} "
          f"({'full' if args.full else 'reduced'} config)")
    print("sampled ids:", seqs.cpu().numpy()[:, :10])


if __name__ == "__main__":
    main()
