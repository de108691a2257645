#!/usr/bin/env python3
"""Readings for the limits of ``correct``: the port's and the control's.

    python3 bench/control.py --cells <cell> [<cell> ...] --seeds <n> [...]
        [--control-seeds <n> [...]] [--out readings.jsonl]

For every seed, makes each named cell's inputs, builds the port once a
configuration, runs one job of each cell and judges its answer as a run
does (the sound reading); for every control seed, puts the control (the
configuration's reference in the next precision down, ``control`` of its
adapter) in the port's place and judges it the same way.  Prints one
JSON line a reading.  The benchmark's runs never run this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cells, seeds, control_seeds, card, emit):
    """Emit ``{"cell", "seed", "kind", "numbers", ...}`` for each cell at
    each seed (``kind`` "program") and control seed ("control")."""
    from bench import harness
    by_config = {}
    for cell in cells:
        by_config.setdefault(cell.config["name"], []).append(cell)
    for seed in sorted(set(seeds) | set(control_seeds)):
        for group in by_config.values():
            first = group[0]
            torch, device = card.torch, card.device
            t0 = time.perf_counter()
            inputs = first.adapter.generate(torch, first.config, seed, device)
            if seed in seeds:
                built = first.adapter.build(torch, first.config, inputs,
                                            device)
                for cell in group:
                    res = harness.make_job(cell, card, built)()
                    card.synchronize()
                    ans = cell.adapter.answer(cell.config, res)
                    steps, left = int(res.superstep), bool(res.active_any)
                    del res
                    nums = cell.adapter.check(torch, cell.config,
                                              cell.traffic, inputs, [ans],
                                              device)[0]
                    if cell.traffic["stop"] == "drain":
                        nums["undrained"] = float(left)
                    emit({"cell": cell.name, "seed": seed, "kind": "program",
                          "supersteps": steps, "numbers": nums})
                del built
                gc.collect()
                card.free()
            if seed in control_seeds:
                for cell in group:
                    ans = cell.adapter.control(torch, cell.config,
                                               cell.traffic, inputs, device)
                    nums = cell.adapter.check(torch, cell.config,
                                              cell.traffic, inputs, [ans],
                                              device)[0]
                    emit({"cell": cell.name, "seed": seed, "kind": "control",
                          "numbers": nums})
            del inputs
            gc.collect()
            card.free()
            print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", nargs="+", required=True)
    p.add_argument("--seeds", nargs="*", type=int, default=[])
    p.add_argument("--control-seeds", nargs="*", type=int, default=[])
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench import harness
    from bench.card import CudaCard
    cells = [harness.load_cell(name) for name in args.cells]
    card = CudaCard(torch, max(c.chips for c in cells))
    out = args.out.open("a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    try:
        readings(cells, args.seeds, args.control_seeds, card, emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
