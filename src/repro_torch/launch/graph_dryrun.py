"""Pod-scale dry run of the paper's own workload: the distributed chromatic
engine on 256 shards (``repro.launch.graph_dryrun`` in PyTorch).

A synthetic preferential-attachment graph (the reference's generator)
becomes a PageRank graph, is two-phase-partitioned onto the shards
(``seed=0``), and the distributed chromatic engine runs a fixed number
of supersteps over a ``LocalMesh`` of that many shards on one device:
every shard's sweep launches the ``ell_spmv`` kernel on the card.  It
prints the plan (R, Hv, colors, host seconds) and its sizes
(``plan_summary``), each superstep's updates and time, and the
``total_rank`` sync.

    PYTHONPATH=src python -m repro_torch.launch.graph_dryrun \\
        [--vertices 16384] [--shards 256] [--supersteps 4] [--device cpu]

Runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.apps import pagerank
from repro_torch.core.partition import cut_edges, two_phase_partition
from repro_torch.device import resolve_device


def web_graph(n_vertices: int, seed: int = 0) -> np.ndarray:
    """The reference's preferential-attachment-ish web graph: each vertex
    after the first links to 1-3 uniformly drawn earlier vertices;
    sorted unique undirected edges [E, 2] int64."""
    rng = np.random.default_rng(seed)
    edges = set()
    for v in range(1, n_vertices):
        for _ in range(int(rng.integers(1, 4))):
            u = int(rng.integers(0, max(v, 1)))
            if u != v:
                edges.add((min(u, v), max(u, v)))
    return np.asarray(sorted(edges), dtype=np.int64)


def plan_summary(plan, edges: np.ndarray) -> tuple[str, dict]:
    """A plan's shapes and the bytes a chromatic superstep's exchanges
    move (4-byte vertex rows, the backflow's 8-byte rows): real entries,
    and the uniform buffers the exchanges carry.  Returns the text and
    ``{"real_bytes", "buffer_bytes"}``."""
    ghosts = ((plan.local_to_global >= 0) & ~plan.owned_mask).sum(axis=1)
    real_v, real_t = int(plan.send_mask.sum()), int(plan.tsend_mask.sum())
    m, c = plan.M, plan.n_colors
    buf_v, buf_t = c * m * m * plan.Hv * 4, c * m * m * plan.Hg * 8
    text = (f"R {plan.R} rows a shard (owned at most "
            f"{int(plan.owned_mask.sum(axis=1).max())}), ghosts a shard "
            f"{ghosts.tolist()}, cut edges {cut_edges(plan.assignment, edges)}"
            f", E_loc {plan.E_loc}, Cmax {plan.Cmax}, Hv {plan.Hv}, Hg "
            f"{plan.Hg}, sliced slots a shard {plan.sliced_slots} ("
            f"{plan.bucket_launches}); a superstep's exchanges: ghost push "
            f"{4 * real_v} bytes real / {buf_v} in buffers, backflow "
            f"{8 * real_t * c} real / {buf_t} in buffers")
    return text, dict(real_bytes=4 * real_v + 8 * real_t * c,
                      buffer_bytes=buf_v + buf_t)


def build(n_vertices: int, n_shards: int, supersteps: int, device=None):
    """``(engine, edges, host seconds)``: the partitioned PageRank engine
    of the dry run on ``device`` (the GPU unless ``"cpu"``)."""
    device = resolve_device(device)
    edges = web_graph(n_vertices)
    t0 = time.perf_counter()
    g = pagerank.make_graph(edges, n_vertices, device=device)
    asg = two_phase_partition(n_vertices, edges, n_shards, seed=0)
    eng = api.build_engine(
        g, pagerank.make_update(1e-4), scheduler="chromatic",
        syncs=[pagerank.total_rank_sync()], n_shards=n_shards,
        partition=asg, max_supersteps=supersteps, device=device)
    return eng, edges, time.perf_counter() - t0


def run_supersteps(eng, supersteps: int):
    """``(result, updates, ms)``: ``eng.run(num_supersteps=...)``'s
    result, with each superstep's updates and wall milliseconds (the
    device synchronized after each)."""
    carry = eng.init_carry()
    updates, ms, done = [], [], 0
    for _ in range(supersteps):
        t0 = time.perf_counter()
        carry = eng._superstep(carry)
        total = int(sum(int(n.item()) for n in carry["n_updates"]))
        ms.append(1e3 * (time.perf_counter() - t0))
        updates.append(total - done)
        done = total
    return eng.finalize(carry), updates, ms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=16384)
    ap.add_argument("--shards", type=int, default=256)
    ap.add_argument("--supersteps", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    eng, edges, t_host = build(args.vertices, args.shards, args.supersteps,
                               device)
    plan = eng.plan
    print(f"graph: {args.vertices} vertices, {len(edges)} edges")
    print(f"plan: {args.shards} shards, R={plan.R} rows/shard, "
          f"Hv={plan.Hv}, colors={plan.n_colors} "
          f"({t_host:.1f}s host-side)")
    print(f"plan sizes: {plan_summary(plan, edges)[0]}")
    t0 = time.perf_counter()
    out, updates, ms = run_supersteps(eng, args.supersteps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    for i, (u, t) in enumerate(zip(updates, ms), 1):
        print(f"superstep {i}: {u} updates, {t:.1f} ms")
    print(f"executed {args.supersteps} supersteps on {args.shards} shards "
          f"({device}) in {dt:.1f}s ({out['n_updates']} updates)")
    total = float(out["globals"]["total_rank"])
    print(f"sync total_rank = {total!r} (N + converging mass)")
    print("pod-scale graph-engine dry-run: OK")


if __name__ == "__main__":
    main()
