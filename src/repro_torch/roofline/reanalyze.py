"""Re-walk the dry run's cached op traces, without running a step again
(``repro.roofline.reanalyze`` in PyTorch).

    PYTHONPATH=src python -m repro_torch.roofline.reanalyze \\
        [--trace-dir results/torch/optrace] [--mesh 16x16] \\
        [--out rows.jsonl] [--merge-from earlier_rows.jsonl]

Each ``<arch>__<shape>__<mesh>.jsonl.gz`` (``launch.dryrun.write_trace``)
holds the row it was written with and the op records; the FLOPs and
bytes are recounted from the records by ``op_walk.cost_of`` (so a change
of the counting rules or of the card's rates reaches every row), the
collectives' bytes by kind from their records (``op_walk.collective_of``),
the sums times the chips as the dry run scales one device's walk, and
``model_flops`` from the config.  The memory record, the walk's time
and the other measured keys come from the trace's own row, or from
``--merge-from`` where that file has the row.  The rows nest the counts
under ``"hlo"`` in the shared trace schema, as the dry run's do.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.profile.trace import results_dir
from repro_torch.roofline import analysis, op_walk

# row keys carried over verbatim (measured by the walk; a re-walk of the
# records cannot recompute them)
_MERGE_KEYS = ("memory", "walk_s", "layers_walked")


def reanalyze_trace(path, merged: dict | None = None) -> dict:
    """The row of one cached trace, recounted."""
    from repro_torch.launch.dryrun import read_trace
    prev, trace = read_trace(path)
    prev = {**prev, **(merged or {}).get((prev["name"], prev["mesh"]), {})}
    arch, shape_name = prev["name"].split(":")
    mf = prev["model_flops"]
    if arch in configs.REGISTRY and shape_name in INPUT_SHAPES:
        mf = analysis.model_flops(configs.get(arch), INPUT_SHAPES[shape_name])
    chips = prev["chips"]
    cost = op_walk.cost_from_records(trace).scaled(chips)
    rf = analysis.Roofline(
        name=prev["name"], mesh=prev["mesh"], chips=chips,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes,
        coll_bytes=cost.coll_bytes, model_flops=mf,
        bytes_per_chip=prev["memory"]["peak_gb"] * 1e9)
    row = rf.row()
    row["hlo"] = cost.counts(collectives=chips > 1)
    row["bytes_by_op"] = {k: int(v) for k, v in cost.bytes_by_op.items()}
    row["ops"] = sum(n for _, n in trace)
    for key in _MERGE_KEYS:
        if key in prev:
            row[key] = prev[key]
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", default=None,
                    help="default: results/torch/optrace")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--out", default=None)
    ap.add_argument("--merge-from", default=None,
                    help="existing jsonl to take the measured keys from")
    args = ap.parse_args(argv)
    trace_dir = args.trace_dir or os.fspath(results_dir() / "optrace")

    merged = {}
    if args.merge_from and os.path.exists(args.merge_from):
        with open(args.merge_from) as f:
            for line in f:
                row = json.loads(line)
                if "error" not in row:
                    merged[(row["name"], row["mesh"])] = {
                        k: row[k] for k in _MERGE_KEYS if k in row}

    rows = []
    for path in sorted(glob.glob(os.path.join(
            trace_dir, f"*__{args.mesh}.jsonl.gz"))):
        row = reanalyze_trace(path, merged)
        rows.append(row)
        print(f"{row['name']:45s} Tc={row['t_compute_s']:.3e} "
              f"Tm={row['t_memory_s']:.3e} Tx={row['t_collective_s']:.3e} "
              f"-> {row['bottleneck']}")
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
