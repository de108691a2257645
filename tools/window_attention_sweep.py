#!/usr/bin/env python3
"""Time ``window_attention`` at ``chip_smoke.py``'s phase-8 shapes under
several split plans, on one GPU.

    python3 tools/window_attention_sweep.py \\
        [--plans '_WAVE_FILL=0.5;_F32_BLOCKS_PER_SM=8'] [--json PATH] \\
        [--layouts]

A plan sets constants of ``window_attention``'s split planner
(``_WAVE_FILL``, ``_F32_BLOCKS_PER_SM``, ``_MIN_SPLIT_ROWS``); the empty
plan is the planner as it stands.  Every plan runs phase 8: each shape
checked against the plain version within ``ATTN_TOL``, timed beside it,
the library call and the bound.  The plans run in turns, first to last
and back again, so a difference is not the card warming up.  First it
times a ``torch.sum`` over decode_32k's K and V, the card's rate for a
plain read of the same bytes.  Prints a table of kernel times and, with
``--json PATH``, writes every case there.

``--layouts`` instead times decode_32k (bf16, full) for the kernel,
``scaled_dot_product_attention`` and ``torch.sum`` with K/V in the
cache's layout and head-major, after an L2 flush that leaves the L2
dirty (as phase 8 flushes it) and one that leaves it clean.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def layout_probe(torch, chip_smoke, dev):
    """decode_32k, bf16, full: the kernel, SDPA and a torch.sum over the
    same bytes, with K/V in the cache's layout ([B, W, Hkv, dh] in
    memory) and head-major ([B, Hkv, W, dh] in memory, the same
    [B, W, Hkv, dh] view), after a dirty and a clean L2 flush."""
    import torch.nn.functional as F

    from repro_torch.kernels.window_attention import window_attention
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, hkv, w, dh = 4, 32, 8, 32768, 128
    q = torch.randn((b, h, dh), generator=gen, device=dev)
    k = torch.randn((b, w, hkv, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn((b, w, hkv, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    kvl = torch.full((b,), w, dtype=torch.int32, device=dev)
    layouts = {"cache": (k, v),
               "head-major": tuple(x.transpose(1, 2).contiguous()
                                   .transpose(1, 2) for x in (k, v))}
    dirty = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device=dev)

    class Clean:                 # a flush that reads instead of writing
        def zero_(self):
            dirty.sum(dtype=torch.int32)
    for lname, (kk, vv) in layouts.items():
        qs = q.to(torch.bfloat16)[:, :, None, :]
        ks, vs = kk.transpose(1, 2), vv.transpose(1, 2)
        mask = torch.ones((b, 1, 1, w), dtype=torch.bool, device=dev)
        fns = {
            "kernel": lambda: window_attention(q, kk, vv, kvl),
            "sdpa": lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True),
            "torch.sum": lambda: (kk.sum(dtype=torch.float32),
                                  vv.sum(dtype=torch.float32))}
        for fname, flush in (("dirty", dirty), ("clean", Clean())):
            row = "  ".join(
                f"{n} {chip_smoke.time_cuda(torch, fn, 20, flush)[0]:.4f}"
                for n, fn in fns.items())
            print(f"layout {lname}, L2 flushed {fname}: {row} ms")


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels import window_attention as wa
    ap = argparse.ArgumentParser()
    ap.add_argument("--plans", default="",
                    help="';'-separated plans, each comma-separated "
                         "NAME=VALUE settings of window_attention's split "
                         "planner constants; empty: the planner as it "
                         "stands")
    ap.add_argument("--json", type=Path,
                    help="write every plan's cases to this file")
    ap.add_argument("--layouts", action="store_true",
                    help="only time decode_32k in two memory layouts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    dev = chip_smoke.cuda_device(torch)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.layouts:
        layout_probe(torch, chip_smoke, dev)
        return 0
    # the card's rate for a plain read: torch.sum over decode_32k's K and
    # V (537 MB of bf16), L2 flushed as phase 8 flushes it
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device=dev)
    kv = torch.randn((2, 4, 32768, 8, 128), device=dev).to(torch.bfloat16)
    ms, _ = chip_smoke.time_cuda(torch, lambda: kv.sum(dtype=torch.float32),
                                 20, flush)
    print(f"torch.sum over {kv.numel() * 2 / 1e6:.1f} MB of bf16: {ms:.4f} ms "
          f"({kv.numel() * 2 / ms / 1e9:.3f} TB/s)")
    del kv, flush
    plans = [tuple((kv.split("=")[0], float(kv.split("=")[1]))
                   for kv in p.split(",") if kv)
             for p in args.plans.split(";")]
    defaults = {name: getattr(wa, name) for plan in plans for name, _ in plan}
    ctx = {"dev": dev}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = wa.body_info(dev, 128)["blocks_per_sm"]
    runs = []
    for plan in plans + plans[::-1]:
        for key, value in defaults.items():
            setattr(wa, key, value)
        for key, value in plan:
            setattr(wa, key, type(defaults[key])(value))
        wa.split_rows.cache_clear()
        splits = wa.split_rows(32, 32768, sms, 4, 128, torch.bfloat16,
                               resident)
        print(f"--- plan {plan}: decode_32k bf16 splits {splits}")
        chip_smoke.phase_attention(torch, ctx)
        runs.append({"plan": plan, "cases": ctx["attn_cases"]})
    labels = [c["label"] for c in runs[0]["cases"]]
    cols = [",".join(f"{k}={v:g}" for k, v in p) or "as it stands"
            for p in plans]
    print("kernel ms, two runs each; bound and library (first run) ms")
    print(f"{'case':<40}" + "".join(f"{c[:17]:>18}" for c in cols)
          + f"{'bound':>9}{'library':>9}")
    for i, label in enumerate(labels):
        cells = [f"{runs[j]['cases'][i]['ms']:8.4f}/"
                 f"{runs[-1 - j]['cases'][i]['ms']:<8.4f}"
                 for j in range(len(plans))]
        c = runs[0]["cases"][i]
        print(f"{label[:39]:<40}" + " ".join(cells)
              + f"{c['bound_ms']:9.4f}{c['library_ms']:9.4f}")
    if args.json:
        args.json.write_text(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
