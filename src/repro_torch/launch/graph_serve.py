"""Online graph serving driver (DESIGN.md §13), on the port.

The twin of ``repro.launch.graph_serve``, with the same flags: replays
a deterministic ``edge_stream`` mutation / query trace against a
long-lived ``ServingEngine``.  Each batch inserts edges into the slack
slots, refreshes the PageRank weights at the new edges, rewrites
touched vertex data, answers read queries from the published snapshot
(never waiting on the recompute), then seeds the scheduler with the
dirty scope and converges again incrementally.  Runs on the GPU unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.graph_serve \\
        [--vertices 1000] [--batches 8] [--rate 8] [--scheduler locking] \\
        [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.apps import pagerank
from repro_torch.core.graph import zipf_edges
from repro_torch.data.pipeline import edge_stream
from repro_torch.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=1000)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--scheduler", default="chromatic",
                    choices=["chromatic", "locking"])
    ap.add_argument("--slack", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-launches", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    nv = args.vertices
    edges = zipf_edges(nv, seed=args.seed)
    graph, update, syncs = pagerank.build(edges, nv, slack=args.slack,
                                          device=device)
    kwargs = {"dispatch": "batch", "max_pending": 64} \
        if args.scheduler == "locking" else {}
    serving = api.serve(graph, update, syncs=syncs,
                        scheduler=args.scheduler, slack=args.slack,
                        device=device, **kwargs)
    t0 = time.time()
    r = serving.recompute()
    _sync(device)
    print(f"graph: {nv} vertices, {len(edges)} edges on {device}; initial "
          f"converge {r['supersteps']} supersteps in {time.time() - t0:.2f}s")

    for batch in edge_stream(nv, rate=args.rate, seed=args.seed + 1,
                             n_batches=args.batches):
        t0 = time.time()
        inserted = 0
        fresh = np.asarray([e for e in batch.edges.tolist()
                            if serving.find_edge(*e) is None],
                           np.int64).reshape(-1, 2)
        if len(fresh):
            ids = serving.add_edges(
                fresh, {"w": np.zeros(len(fresh), np.float32)})
            inserted = len(ids)
            touched = np.unique(fresh.ravel())
            eids, vals = pagerank.refreshed_weights(serving, touched)
            serving.update_edge_data(eids, vals)
        if len(batch.touch):
            # query traffic that writes: re-seed the touched ranks
            serving.update_vertex_data(
                batch.touch,
                {"rank": np.ones(len(batch.touch), np.float32)})
        # reads come from the pinned snapshot, before the recompute
        snap = serving.snapshot()
        ranks = snap.read_vertex(batch.queries, "rank")
        r = serving.recompute(track_launches=args.trace_launches)
        _sync(device)
        dt = time.time() - t0
        line = (f"[t={batch.t}] +{inserted} edges, "
                f"{len(batch.touch)} touches, {len(batch.queries)} reads "
                f"(mean rank {float(np.mean(ranks)) if len(ranks) else 0:.3f}) "
                f"| dirty={r['dirty']} supersteps={r['supersteps']} "
                f"updates={r['updates']} {dt:.2f}s")
        if args.trace_launches and r["launches"]:
            rows = [x["rows"] for x in r["launches"] if "rows" in x]
            line += (f" launches={len(r['launches'])} "
                     f"max_rows={max(rows or [0])}")
        print(line)

    snap = serving.snapshot()
    ids, vals = snap.top_k("rank", 5)
    print(f"final: {serving.n_edges} edges "
          f"(+{serving.stats['edges_inserted']} live, "
          f"{serving.stats['compactions']} compactions); top-5 rank: "
          + ", ".join(f"v{int(i)}={float(v):.3f}" for i, v in zip(ids, vals)))


if __name__ == "__main__":
    main()
