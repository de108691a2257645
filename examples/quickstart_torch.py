"""Quickstart on the PyTorch/CUDA port: the paper's running example
(PageRank, Ex. 3.1 + §3.3) through ``repro_torch.api``.

The first half of ``examples/quickstart.py``, on the port: build the
data graph, run the chromatic engine to convergence, and read the sync
ops.  Runs on the GPU by default; ``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import api
from repro_torch.apps import pagerank


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args()

    rng = np.random.default_rng(0)
    n = 200
    # preferential-attachment-ish web graph
    edges = set()
    for v in range(1, n):
        for _ in range(rng.integers(1, 4)):
            u = int(rng.integers(0, v))
            edges.add((u, v))
    edges = np.asarray(sorted(edges))

    graph, update, syncs = pagerank.build(edges, n, eps=1e-5,
                                          device=args.device)
    print(f"data graph: {n} vertices, {len(edges)} edges, "
          f"{graph.n_colors} colors on {graph.device} | schedulers: "
          f"{', '.join(api.list_schedulers())}")

    result = api.run(graph, update, syncs=syncs, scheduler="chromatic",
                     max_supersteps=100, device=args.device)

    ranks = result.vertex_data["rank"].cpu().numpy()
    top = np.argsort(-ranks)[:5]
    print(f"converged in {result.superstep} supersteps, "
          f"{result.n_updates} update-function calls "
          f"(adaptive: {result.n_updates / (result.superstep * n):.0%} "
          f"of a full-sweep schedule)")
    print("top pages:", [(int(v), round(float(ranks[v]), 3)) for v in top])
    second_rank, _ = result.globals["top2"]
    print(f"sync op 'second most popular page': rank={float(second_rank):.3f}"
          f" (oracle: {sorted(ranks)[-2]:.3f})")
    assert float(second_rank) == sorted(ranks)[-2]
    print(f"sync op 'total rank': {float(result.globals['total_rank']):.2f}")


if __name__ == "__main__":
    main()
