"""The paper's Netflix experiment (§5.1) in miniature, on the PyTorch/CUDA
port: ALS collaborative filtering through ``repro_torch.api``.

Synthetic ratings -> bipartite data graph -> the chromatic engine with
the RMSE sync, on one shard or, with ``--shards N``, on N shards of the
distributed chromatic engine (the paper's random partition of the dense
bipartite graph; the shards share the device through a ``LocalMesh``)
-> the Hadoop-style and MPI-style baselines on the same device (§6.2).
The normal equations go through the ``als_normal_eq`` CUDA kernel
everywhere.  Runs on the GPU by default; ``--device cpu`` runs it on the
CPU (the kernel's plain version).

    PYTHONPATH=src python examples/netflix_als_torch.py [--device cpu] [--shards 8]
"""
import argparse
import time

import torch

from repro_torch import api
from repro_torch.apps import als
from repro_torch.baselines.mapreduce import als_mapreduce
from repro_torch.baselines.mpi_als import als_mpi
from repro_torch.core.partition import random_partition
from repro_torch.kernels.als_normal_eq import als_normal_eq

D = 8
SWEEPS = 20


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    parser.add_argument("--shards", type=int, default=1,
                        help="shards of the distributed engine (default 1: "
                             "the single-shard engine)")
    args = parser.parse_args()

    prob = als.synthetic_netflix(n_users=300, n_movies=200, d=D,
                                 density=0.06, noise=0.08, seed=0,
                                 device=args.device)
    g, upd, syncs = als.build(prob, lam=0.05, eps=1e-3)
    print(f"Netflix-style problem: {prob.n_users} users x "
          f"{prob.n_movies} movies, {g.n_edges} ratings, d={D}, on "
          f"{g.device}")

    launches = als_normal_eq.launches
    t0 = time.time()
    if args.shards > 1:
        # the paper's §5.1 setup: dense bipartite graph -> random partition
        out = api.run(g, upd, syncs=syncs, scheduler="chromatic",
                      n_shards=args.shards, max_supersteps=SWEEPS,
                      partition=random_partition(g.n_vertices, args.shards,
                                                 seed=1),
                      device=args.device)
        print(f"distributed on {args.shards} shards: "
              f"{int(out.engine.plan.send_mask.sum())} ghost rows a "
              f"superstep")
    else:
        out = api.run(g, upd, syncs=syncs, scheduler="chromatic",
                      max_supersteps=SWEEPS, device=args.device)
    t_gl = time.time() - t0
    rmse = als.dataset_rmse(prob, out.vertex_data)
    print(f"GraphLab ALS: {out.superstep} supersteps, {out.n_updates} "
          f"updates, {t_gl:.2f}s | sync RMSE {float(out.globals['rmse']):.4f} "
          f"(exact {rmse:.4f}, noise floor ~{prob.noise}) | als_normal_eq "
          f"kernel launches {als_normal_eq.launches - launches}")

    # --- baselines (paper §6.2) ---
    t0 = time.time()
    out_mr, stats = als_mapreduce(prob, SWEEPS, lam=0.05)
    t_mr = time.time() - t0
    w = torch.cat([out_mr["w_users"], out_mr["w_movies"]])
    print(f"Hadoop-style ALS: {t_mr:.2f}s | RMSE "
          f"{als.dataset_rmse(prob, {'w': w}):.4f} | shuffles "
          f"{stats.bytes_shuffled_per_iter / 1e6:.1f} MB/iter")

    t0 = time.time()
    wu, wv, info = als_mpi(prob, SWEEPS, n_devices=max(args.shards, 1),
                           lam=0.05)
    t_mpi = time.time() - t0
    print(f"MPI-style ALS on {max(args.shards, 1)} shards: {t_mpi:.2f}s | "
          f"RMSE {als.dataset_rmse(prob, {'w': torch.cat([wu, wv])}):.4f} | "
          f"all-gathers {info['bytes_per_iter'] / 1e6:.2f} MB/iter")


if __name__ == "__main__":
    main()
