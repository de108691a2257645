"""Kill a distributed PageRank run mid-flight and watch it recover,
bitwise, from its latest sharded snapshot (DESIGN.md §12), on the port.

The three acts of ``examples/kill_resume.py``, through ``repro_torch.api``
on two ``LocalMesh`` shards of one device:

1. an uninterrupted run: the ground truth;
2. the same run with ``checkpoint_every=`` snapshots and an injected
   kill at the halfway superstep: the supervisor restores the newest
   valid snapshot, replays the remaining supersteps, and the result
   matches act 1 to the bit (``RunResult.restarts`` shows what
   happened);
3. an explicit ``resume_from=`` of one of those snapshots, the
   operator's path after a real crash: the partition is rebuilt from
   the snapshot's stored assignment, so no plan arguments repeat.

Runs on the GPU by default; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/kill_resume_torch.py [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch import api
from repro_torch.apps import pagerank
from repro_torch.core.graph import zipf_edges
from repro_torch.ft import FaultEvent, FaultPlan, latest_valid_snapshot

N, STEPS, KILL_AT = 400, 12, 6


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args()
    edges = zipf_edges(N, seed=7)
    graph, update, syncs = pagerank.build(edges, N, device=args.device)
    part = np.arange(N, dtype=np.int64) % 2      # two shards
    kw = dict(syncs=syncs, scheduler="chromatic", n_shards=2,
              num_supersteps=STEPS, device=args.device)

    # --- act 1: the unfaulted ground truth ---------------------------
    base = api.run(graph, update, partition=part, **kw)
    rank = base.vertex_data["rank"].cpu().numpy()
    print(f"ground truth: {base.superstep} supersteps, "
          f"{base.n_updates} updates on {graph.device}")

    with tempfile.TemporaryDirectory() as ckpt:
        # --- act 2: checkpoint + injected kill + supervised restart --
        faults = FaultPlan([FaultEvent("kill", superstep=KILL_AT)])
        rec = api.run(graph, update, partition=part, **kw,
                      checkpoint_every=2, checkpoint_dir=ckpt,
                      faults=faults)
        for r in rec.restarts:
            print(f"restart {r.attempt}: {r.error_type} "
                  f"({r.error}) -> restored superstep "
                  f"{r.restored_superstep}, backoff {r.backoff_s:.2f}s")
        same = np.array_equal(rank, rec.vertex_data["rank"].cpu().numpy())
        print(f"recovered run bitwise-equal to ground truth: {same}")
        assert same

        # --- act 3: operator-style resume_from after a "crash" -------
        assert latest_valid_snapshot(ckpt) is not None
        snap = os.path.join(ckpt, f"step_{KILL_AT:08d}")   # mid-run one
        print(f"resuming from {os.path.basename(snap)} "
              "(partition rebuilt from the snapshot)")
        res = api.run(graph, update, resume_from=snap, **kw)
        same = np.array_equal(rank, res.vertex_data["rank"].cpu().numpy())
        print(f"resumed run bitwise-equal to ground truth: {same}")
        assert same


if __name__ == "__main__":
    main()
