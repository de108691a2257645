#!/usr/bin/env python3
"""Connected components under the distributed locking engine on a Zipf
graph: the supersteps, updates and time to drain for several pending
windows a shard, each run checked against union-find.

    python3 tools/dist_cc_windows.py [--vertices 2097152] [--shards 8] \\
        [--windows 512,1024,2048,4096,16384,65536,R] [--device cpu]

The graph is ``chip_smoke.py``'s (``zipf_edges(n, alpha=2.0,
max_deg=256, seed=0)``), partitioned by ``two_phase_partition(seed=0)``;
the shards share the device through a ``LocalMesh``.  ``R`` is a
saturating window (``max_pending`` = the plan's rows a shard), the
regime in which the distributed run equals the single-shard one bitwise.
Times are host wall clocks with the device drained; on the CPU they are
not device numbers.  No ``--device`` means the GPU.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    import torch

    from repro_torch import api
    from repro_torch.apps import cc
    from repro_torch.core.distributed import ShardPlan
    from repro_torch.core.graph import DataGraph, zipf_edges
    from repro_torch.core.partition import two_phase_partition
    from repro_torch.device import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vertices", type=int, default=2 ** 21)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--windows", default="512,1024,2048,4096,16384,65536")
    ap.add_argument("--max-supersteps", type=int, default=12_000)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    n = args.vertices
    edges = zipf_edges(n, alpha=2.0, max_deg=256, seed=0)
    g = DataGraph.from_edges(n, edges,
                             {"label": np.arange(n, dtype=np.int32)},
                             device=dev)
    truth = cc.reference_components(edges, n)
    t0 = time.perf_counter()
    plan = ShardPlan.build(
        g, two_phase_partition(n, g.edges_np, args.shards, seed=0),
        args.shards)
    print(f"{n} vertices, {len(edges)} edges, {args.shards} shards on "
          f"{dev}: R {plan.R} rows a shard; partition and plan "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for w in args.windows.split(","):
        window = plan.R if w == "R" else int(w)
        sync()
        t0 = time.perf_counter()
        res = api.run(g, cc.make_update(), scheduler="locking",
                      n_shards=args.shards, partition=plan,
                      max_pending=window,
                      max_supersteps=args.max_supersteps, device=dev)
        sync()
        wall = time.perf_counter() - t0
        same = np.array_equal(res.vertex_data["label"].cpu().numpy(), truth)
        print(f"window {window} a shard: {res.superstep} supersteps, "
              f"{res.n_updates} updates, {wall:.2f} s "
              f"({1e3 * wall / max(res.superstep, 1):.2f} ms a superstep), "
              f"drained {not res.active_any}, == union-find {same}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
