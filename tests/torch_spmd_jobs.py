"""The partitioned steps of ``test_torch_spmd.py``: tiny dense and MoE
configs, their training and decode steps built on the CPU (real values)
or on meta, run plain or as DTensors on a torch mesh under the op
walker, and a gloo worker that runs them on a 2 x 2 mesh of processes.
No JAX here: the gloo ranks are spawned processes that import this
module.  Other architectures go through the same comparison from the
command line (about 50 s for two):

    PYTHONPATH=src python tests/torch_spmd_jobs.py falcon-mamba-7b jamba-1.5-large-398b
"""
import json

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import InputShape
from repro_torch.data import pipeline
from repro_torch.launch import dryrun, shardctx
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.roofline import op_walk
from repro_torch.serve import engine as serve_engine
from repro_torch.train.steps import (make_serve_step, make_train_step,
                                     param_dict)

MESH = DeviceMesh(("data", "model"), (2, 2))
TINY = {"dense": "qwen3-4b", "moe": "qwen3-moe-235b-a22b"}
SHAPES = {"train": InputShape("t", 32, 4, "train"),
          # 4,096 rows: the cache's rows go over "model"
          "decode": InputShape("d", 4096, 4, "decode")}
# tokens seen per request: request 0 ends inside the first shard of rows,
# request 3 covers less than one shard, so the second shard is empty
CACHE_LEN = (100, 3000, 4095, 50)


def tiny(name: str, archs: dict = TINY):
    return configs.get(archs[name]).reduced()


def make_args(cfg, kind: str, device: str) -> dict:
    """The step's float32 arguments: seeded values on the CPU, or empty
    tensors of the same shapes on meta."""
    shape = SHAPES[kind]
    if device == "meta":
        params = model_lib.Model(cfg, None, torch.float32, "meta")
    else:
        params = model_lib.init_params(cfg, seed=0, dtype=torch.float32,
                                       device=device)
    if kind == "train":
        if device == "meta":
            batch = pipeline.train_input_specs(cfg, shape)
        else:
            batch = pipeline.make_batch(cfg, shape.global_batch,
                                        shape.seq_len, seed=1, device=device)
        return {"params": params, "opt": adamw.init(param_dict(params)),
                "batch": batch}
    state = serve_engine.init_cache(cfg, shape.global_batch, shape.seq_len,
                                    dtype=torch.float32, device=device)
    gen = np.random.default_rng(2)
    if device != "meta":
        for t in (state.cache_k, state.cache_v):
            if t is not None:
                t.copy_(torch.from_numpy(gen.standard_normal(
                    t.shape, dtype=np.float32)))
        state.cache_len.copy_(torch.tensor(CACHE_LEN, dtype=torch.int32))
    token = torch.from_numpy(gen.integers(
        0, cfg.vocab, (shape.global_batch, 1)).astype(np.int32)).to(device)
    return {"params": params, "token": token, "state": state}


def run(cfg, kind: str, args: dict, tm=None):
    """The step on ``args`` (distributed on ``tm`` first, where given)
    under the op walker: ``(outputs, walk)``, the outputs the loss or
    the logits and the caches, whole."""
    shape = SHAPES[kind]
    if tm is not None:
        args = dryrun.distribute_args(cfg, shape, tm, args, fsdp=True)
    if kind == "train":
        step = make_train_step(cfg, adamw.AdamWConfig())
        fn = lambda: step(args["params"], args["opt"], args["batch"])
    else:
        step = make_serve_step(cfg)
        fn = lambda: step(args["params"], args["token"], args["state"])
    with op_walk.OpWalk() as w:
        w.adopt(dryrun._tensors(args))
        out = fn()
    if kind == "train":
        outs = {"loss": out[2]["loss"]}
    else:
        logits, state = out
        outs = {k: v for k, v in (("logits", logits),
                                   ("cache_k", state.cache_k),
                                   ("cache_v", state.cache_v))
                if v is not None}
    if next(iter(outs.values())).device.type == "meta":
        return outs, w
    return {k: _whole(v) for k, v in outs.items()}, w


def _whole(t):
    if shardctx.is_distributed(t):
        t = t.full_tensor()
    return t.detach().numpy()


def breakdown(walk) -> dict:
    """One device's collectives by kind: ``{kind: (count, bytes)}``."""
    b = op_walk.cost_from_records(walk.trace()).breakdown()
    return {k: (b["counts"][k], b[k]) for k in op_walk.COLLECTIVES}


def gloo_worker(rank: int, world: int, store_path: str, out_path: str,
                archs: dict = TINY):
    """One rank of the 2 x 2 gloo mesh: every (config, step) as DTensors,
    and on rank 0 plain too; then rank 0 runs the same steps on meta
    over a fake group of the mesh's size (``fake_breakdowns``, with
    DTensor's sharding decisions already cached) and saves the outputs,
    its collectives and the fake group's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    torch.set_num_threads(1)
    dist.init_process_group("gloo",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    out = {}
    try:
        tm = init_device_mesh("cpu", MESH.shape,
                              mesh_dim_names=MESH.axis_names)
        for name in archs:
            cfg = tiny(name, archs)
            for kind in SHAPES:
                with shardctx.use_mesh(MESH), implicit_replication():
                    got, walk = run(cfg, kind, make_args(cfg, kind, "cpu"),
                                    tm)
                if rank:
                    continue
                plain, _ = run(cfg, kind, make_args(cfg, kind, "cpu"))
                for k in got:
                    out[f"{name}.{kind}.{k}"] = got[k]
                    out[f"{name}.{kind}.{k}.plain"] = plain[k]
                for k, (n, b) in breakdown(walk).items():
                    out[f"{name}.{kind}.coll.{k}"] = np.asarray([n, b])
    finally:
        dist.destroy_process_group()
    if rank == 0:
        for key, br in fake_breakdowns(archs).items():
            name, kind = key[:2]
            if len(key) == 3:
                out[f"{name}.{kind}.fake.all_reduce"] = np.asarray(
                    json.dumps(br))
                continue
            for k, (n, b) in br.items():
                out[f"{name}.{kind}.fake.{k}"] = np.asarray([n, b])
        np.savez(out_path, **out)


def run_gloo(tmp_path, archs: dict = TINY) -> dict:
    """The gloo run on four spawned processes (a ``FileStore`` under
    ``tmp_path``, no port); rank 0's arrays."""
    import torch.multiprocessing as mp
    store = str(tmp_path / "store_spmd")
    out = str(tmp_path / "out_spmd.npz")
    mp.spawn(gloo_worker, args=(MESH.size, store, out, archs),
             nprocs=MESH.size)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def fake_breakdowns(archs: dict = TINY) -> dict:
    """The same steps on meta over a fake group of the mesh's size:
    ``{(config, step): breakdown}``."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.mesh import torch_mesh
    out = {}
    with torch_mesh(MESH) as tm, shardctx.use_mesh(MESH), \
            implicit_replication():
        for name in archs:
            cfg = tiny(name, archs)
            for kind in SHAPES:
                _, walk = run(cfg, kind, make_args(cfg, kind, "meta"), tm)
                out[(name, kind)] = breakdown(walk)
                out[(name, kind, "all_reduce")] = all_reduces(walk)
    return out


def all_reduces(walk) -> list:
    """``[reduce op, output shape, count]`` of each all-reduce record."""
    return [[rec[1][1], list(rec[3][1]), n] for rec, n in walk.trace()
            if rec[0] == "c10d.all_reduce.default"]


def main(argv=None) -> int:
    """The gloo comparison for the architectures named: each output's
    max |diff| / max |plain| and whether rank 0's collectives are the
    fake group's."""
    import argparse
    import pathlib
    import tempfile
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="+", choices=configs.ARCHS)
    archs = {a: a for a in ap.parse_args(argv).archs}
    with tempfile.TemporaryDirectory() as tmp:
        out = run_gloo(pathlib.Path(tmp), archs)
    ok = True
    for name in archs:
        for kind in SHAPES:
            key = f"{name}.{kind}"
            errs = {k[len(key) + 1:]: float(np.abs(out[k] - out[k + ".plain"])
                                            .max() / np.abs(out[k + ".plain"])
                                            .max())
                    for k in out if k.startswith(key + ".")
                    and "." not in k[len(key) + 1:]}
            same = all((out[f"{key}.coll.{c}"] == out[f"{key}.fake.{c}"])
                       .all() for c in op_walk.COLLECTIVES)
            ok &= same and max(errs.values()) <= 1e-5
            print(f"{key}: max |diff| / max |plain| "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f"; collectives equal the fake group's: {same}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
