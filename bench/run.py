#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Makes the cell's inputs from the seed,
builds, warms up, runs jobs for ``--seconds``, judges every job's
answer against the plain reference, and prints one JSON line last on
standard output (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics).  Exits non-zero with no result
without the cards the cell asks for, or if JAX or the JAX package was
loaded.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    from bench import harness
    from bench.card import CudaCard, NoCard
    cell = harness.load_cell(args.workload)
    import torch
    try:
        card = CudaCard(torch, cell.chips)
    except NoCard as err:
        print(f"no result: {err}", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), card, started=STARTED)
    except harness.ForbiddenModules as err:
        print(f"no result: {err}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
