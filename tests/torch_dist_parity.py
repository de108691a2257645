"""Helpers of the tests that hold the port's distributed engines against
the reference's: the graphs the reference's distributed tests run on,
the reference's engines run in a subprocess on 8 virtual devices (XLA's
device count must be set before JAX starts, and the test process keeps
one device), and the port's engines run under ``torch.distributed``
gloo ranks, one shard a process.  The ranks import torch and the port
only."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# the reference subprocess's prelude: 8 host devices, then JAX
REF_PRELUDE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    OUT = sys.argv[1]
    def graph80():
        rng = np.random.default_rng(1)
        edges = set()
        while len(edges) < 200:
            u, v = rng.integers(0, 80, 2)
            if u != v:
                edges.add((min(u, v), max(u, v)))
        return np.array(sorted(edges))
""")


def graph80() -> np.ndarray:
    """The 80-vertex, 200-edge graph of the reference's distributed
    tests (``tests/test_distributed.py``, ``tests/test_locking.py``)."""
    rng = np.random.default_rng(1)
    edges = set()
    while len(edges) < 200:
        u, v = rng.integers(0, 80, 2)
        if u != v:
            edges.add((min(u, v), max(u, v)))
    return np.array(sorted(edges))


def run_reference(script: str, out_path) -> dict:
    """Run ``REF_PRELUDE + script`` (which saves its arrays to ``OUT``
    with ``np.savez``) in a subprocess; returns the arrays."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REF_PRELUDE + textwrap.dedent(script),
         str(out_path)], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


# ----------------------------------------------------------------------
# The port under gloo: one shard a rank
# ----------------------------------------------------------------------

def _gloo_worker(rank: int, world: int, store_path: str, out_path: str,
                 job: str):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world)
    try:
        from repro_torch.core.mesh import ProcessGroupMesh
        out = JOBS[job](ProcessGroupMesh())
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


def run_gloo(job: str, world: int, tmp_path) -> dict:
    """Run ``JOBS[job](mesh)`` on ``world`` gloo ranks (a ``FileStore``
    under ``tmp_path``, no port); returns rank 0's arrays."""
    import torch.multiprocessing as mp
    store = str(tmp_path / f"store_{job}")
    out = str(tmp_path / f"out_{job}.npz")
    mp.spawn(_gloo_worker, args=(world, store, out, job), nprocs=world)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def pagerank_job(mesh) -> dict:
    """Distributed chromatic PageRank on ``graph80`` (eps 1e-5, the
    total-rank sync) over ``mesh``."""
    from repro_torch.apps import pagerank
    from repro_torch.core.distributed import (DistributedChromaticEngine,
                                              ShardPlan)
    from repro_torch.core.partition import two_phase_partition
    edges = graph80()
    g = pagerank.make_graph(edges, 80, device="cpu")
    plan = ShardPlan.build(
        g, two_phase_partition(80, edges, mesh.n_shards, seed=0),
        mesh.n_shards)
    res = DistributedChromaticEngine(
        g, plan, pagerank.make_update(1e-5),
        syncs=[pagerank.total_rank_sync()], max_supersteps=80,
        mesh=mesh).run()
    return dict(rank=res["vertex_data"]["rank"].numpy(),
                n_updates=res["n_updates"], supersteps=res["supersteps"],
                total=res["globals"]["total_rank"].numpy())


def cc_locking_job(mesh) -> dict:
    """Distributed CC on ``graph80`` under chromatic, and under locking
    with a saturating window for 40 supersteps, over ``mesh``."""
    from repro_torch.apps import cc
    from repro_torch.core.distributed import (DistributedChromaticEngine,
                                              ShardPlan)
    from repro_torch.core.engine_locking import DistributedLockingEngine
    from repro_torch.core.partition import two_phase_partition
    edges = graph80()
    g, upd, _ = cc.build(edges, 80, device="cpu")
    plan = ShardPlan.build(
        g, two_phase_partition(80, edges, mesh.n_shards, seed=0),
        mesh.n_shards)
    chrom = DistributedChromaticEngine(g, plan, upd, mesh=mesh).run()
    lock = DistributedLockingEngine(g, plan, upd, max_pending=plan.R,
                                    mesh=mesh).run(num_supersteps=40)
    return dict(chrom=chrom["vertex_data"]["label"].numpy(),
                chrom_updates=chrom["n_updates"],
                lock=lock["vertex_data"]["label"].numpy(),
                lock_updates=lock["n_updates"],
                lock_sent=lock["ghost_rows_sent"],
                lock_full=lock["ghost_rows_full"])


def als_mpi_job(mesh) -> dict:
    """MPI-style ALS (10 iterations) on the reference test's problem,
    its factor blocks gathered over ``mesh``."""
    from repro_torch.apps import als
    from repro_torch.baselines.mpi_als import als_mpi
    prob = als.synthetic_netflix(25, 20, d=3, density=0.4, seed=5,
                                 device="cpu")
    wu, wv, info = als_mpi(prob, 10, lam=0.02, mesh=mesh)
    return dict(w_users=wu.numpy(), w_movies=wv.numpy(),
                bytes_per_iter=info["bytes_per_iter"])


def ft_job(mesh) -> dict:
    """Distributed CC locking (4 pending a shard, 12 supersteps) with a
    kill at 5 and snapshots every 2 supersteps under
    ``$REPRO_TORCH_FT_DIR``, then a resume from step 6 with the plan
    rebuilt from the snapshot; records the snapshot files each rank
    wrote."""
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.apps import cc
    from repro_torch.core.partition import two_phase_partition
    from repro_torch.ft import FaultEvent, FaultPlan
    from repro_torch.ft import snapshot as snap
    ckpt = os.environ["REPRO_TORCH_FT_DIR"]
    written, write = [], snap._write_npz

    def spy(path, arrays):
        written.append(os.path.basename(path))
        write(path, arrays)
    snap._write_npz = spy
    g, upd, _ = cc.build(graph80(), 80, device="cpu")
    kw = dict(scheduler="locking", max_pending=4, n_shards=mesh.n_shards,
              num_supersteps=12, device="cpu", mesh=mesh)
    faulted = api.run(
        g, upd, **kw, checkpoint_every=2, checkpoint_dir=ckpt,
        faults=FaultPlan([FaultEvent("kill", superstep=5)]),
        partition=two_phase_partition(80, g.edges_np, mesh.n_shards,
                                      seed=0))
    resumed = api.run(g, upd, **kw,
                      resume_from=os.path.join(ckpt, "step_00000006"))
    every = [None] * mesh.n_shards
    dist.all_gather_object(every, sorted(set(written)))
    out = {f"written_{r}": np.asarray(w) for r, w in enumerate(every)}
    for key, r in (("faulted", faulted), ("resumed", resumed)):
        out[f"{key}_label"] = r.vertex_data["label"].numpy()
        out[f"{key}_counts"] = [r.superstep, r.n_updates,
                                r.stats["ghost_rows_sent"],
                                r.stats["ghost_rows_full"]]
    out["restarts"] = np.asarray([x.error_type for x in faulted.restarts])
    return out


JOBS = {"pagerank": pagerank_job, "cc_locking": cc_locking_job,
        "als_mpi": als_mpi_job, "ft": ft_job}
