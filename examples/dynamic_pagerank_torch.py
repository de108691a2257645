"""Dynamic PageRank: live graph mutations served by ``api.serve``
(DESIGN.md §13), on the port.

The twin of ``examples/dynamic_pagerank.py``.  ``api.serve`` stores the
graph with slack slots so edge inserts land in place (no rebuild),
tracks the mutated scopes, and seeds only the dirty 1-hop closure into
the scheduler on the next ``recompute()``.  Reads are snapshot-isolated:
a pinned ``GraphSnapshot`` keeps serving the last converged state while
mutations and the recompute proceed.

The final assertion is the contract for float workloads: the
incremental fixed point matches a from-scratch rebuild up to the
eps-scaled tolerance of the adaptive threshold (integer workloads like
connected components match bitwise: tests/test_torch_graph_serve.py).
Runs on the GPU by default; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/dynamic_pagerank_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import api
from repro_torch.apps import pagerank
from repro_torch.core.graph import zipf_edges


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args()
    n = 150
    edges = zipf_edges(n, seed=7)
    graph, update, syncs = pagerank.build(edges, n, slack=4,
                                          device=args.device)
    serving = api.serve(graph, update, syncs=syncs, scheduler="chromatic",
                        slack=4, device=args.device)
    r = serving.recompute()
    print(f"serving {n} vertices, {len(edges)} edges "
          f"(capacity {serving.graph.edge_capacity}) on "
          f"{serving.graph.device}; initial converge: "
          f"{r['supersteps']} supersteps")

    # pin a snapshot, then mutate: reads below never see partial state
    snap = serving.snapshot()

    new_edges = np.asarray([[3, 77], [5, 90], [11, 42]], np.int64)
    serving.add_edges(new_edges,
                      {"w": np.zeros(len(new_edges), np.float32)})
    # this app's edge weights depend on endpoint degrees: refresh the
    # ones at the new edges (the engine dirties their scopes)
    eids, vals = pagerank.refreshed_weights(serving,
                                            np.unique(new_edges.ravel()))
    serving.update_edge_data(eids, vals)

    r = serving.recompute()
    print(f"after +{len(new_edges)} edges: dirty scope {r['dirty']} of "
          f"{n} vertices, re-converged in {r['supersteps']} supersteps, "
          f"{r['updates']} update calls")

    # the pre-mutation snapshot still serves the old fixed point
    old = snap.read_vertex(np.arange(n), "rank")
    new = serving.snapshot().read_vertex(np.arange(n), "rank")
    moved = int(np.sum(np.abs(new - old) > 1e-3))
    ids, vals = serving.snapshot().top_k("rank", 3)
    print(f"snapshot isolation: pinned snapshot unchanged, "
          f"{moved} ranks moved in the new one; top-3: "
          + ", ".join(f"v{int(i)}={float(v):.3f}"
                      for i, v in zip(ids, vals)))

    # equivalence: full rebuild + converge from scratch, the same fixed
    # point up to the eps-adaptive tolerance
    all_edges = np.vstack([edges, new_edges])
    g2, u2, s2 = pagerank.build(all_edges, n, device=args.device)
    res = api.run(g2, u2, syncs=s2, scheduler="chromatic",
                  max_supersteps=2000, device=args.device)
    diff = float(np.abs(new - res.vertex_data["rank"].cpu().numpy()).max())
    print(f"incremental vs full rebuild: max |diff| = {diff:.2e}")
    assert diff < 5e-3, diff
    print("OK")


if __name__ == "__main__":
    main()
