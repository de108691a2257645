"""Dry run of every (arch x input shape) on a mesh, on meta tensors
(``repro.launch.dryrun`` in PyTorch).

The reference compiles each step's SPMD program for the production
mesh and walks one device's HLO.  Here each combination builds its
parameters, optimizer state and batch (or token and ``ServeState``) as
meta tensors, which allocate nothing, runs the real step
(``make_train_step``, ``make_prefill_step`` or ``make_serve_step``)
under the op walker (``roofline.op_walk``), and reports:

* the roofline terms (``roofline.analysis.Roofline``) on the H100 from
  the walked FLOPs, bytes and collective bytes, and ``model_flops``;
* ``memory``: per device, the arguments exactly from the sharding specs
  (``launch.sharding``) and the step's own storages at their peak (the
  walker's); ``hbm_per_chip_gb`` is their sum;
* ``hlo``: the walker's counts in the shared trace schema, with the
  collectives by kind (``coll_breakdown``) on a production mesh.

On a production mesh (any ``DxM`` or ``PxDxM``) the arguments are meta
DTensors under the sharding rules on a fake process group of the mesh's
size (``launch.mesh.torch_mesh``, ``sharding.distribute_tree``), and
DTensor partitions the step as XLA's SPMD partitioner does the
reference's, constrained by the same hints (``launch.shardctx``).  The
walker counts one device's program -- its local ops, its peak, and the
collectives it issues -- and the FLOPs, bytes and collective bytes are
that times the chips, as the reference scales its walk.  A plain tensor
made inside the step (a position ``arange``, a mask) is taken as
replicated.  On one card (``"1"``) the step runs on plain meta tensors.

A prefill walks the model at two and at three periods of layers (a
period is one layer, or the hybrid's ``attn_every``) and extrapolates
each op's count and the peak to the published depth, as the reference
multiplies a scanned layer's body by its trip count: a prefill keeps no
activations between layers, so its counts grow by the same increment a
period and its peak, the largest layer's, stays as it is from the
second layer on.  Training and decode walk every layer.  The op trace goes to
``results/torch/optrace/<arch>__<shape>__<mesh>.jsonl.gz`` (git-ignored;
``roofline.reanalyze`` re-walks it).  Nothing touches a device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k [--mesh 1 | --multi-pod] [--out rows.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh 1]
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import logging
import os
import sys
import time
import traceback

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.data import pipeline
from repro_torch.launch import sharding, shardctx
from repro_torch.launch.mesh import (DeviceMesh, make_production_mesh,
                                     of_torch_mesh, parse_mesh, torch_mesh)
from repro_torch.optim import adamw
from repro_torch.profile.trace import results_dir
from repro_torch.roofline import analysis, op_walk
from repro_torch.train.steps import (make_prefill_step, make_serve_step,
                                     make_train_step, param_dict)


@dataclasses.dataclass
class Walked:
    """A step's op trace (``(record, count)`` pairs), the peak of its own
    storages above its arguments and the bytes of the outputs it
    created, and the layer counts walked (two: extrapolated in
    depth)."""
    trace: list
    peak_bytes: float
    output_bytes: float
    layers: tuple


def walk(run, args=()) -> Walked:
    """Run ``run()`` under an ``OpWalk`` with the tensors of ``args``
    adopted as live; the peak is above them, and the outputs the step
    created count (not the arguments it returns)."""
    with op_walk.OpWalk() as w:
        w.adopt(_tensors(args))
        out = run()
    return Walked(w.trace(), w.temp_bytes, w.created(_tensors(out)), ())


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))
    elif isinstance(x, torch.nn.Module):
        yield from x.parameters()
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _period(cfg: ModelConfig) -> int:
    return cfg.attn_every if cfg.arch_type == "hybrid" else 1


def extrapolate(a: Walked, b: Walked, trips: int) -> Walked:
    """``a`` walked at two periods of layers, ``b`` at three: the step at
    ``trips`` periods, each count and the peak carried on by the last
    period's increment (a prefill's peak is the largest layer's, the
    same from the second layer on)."""
    da, db = dict(a.trace), dict(b.trace)
    trace = []
    for rec in {**da, **db}:
        n = db.get(rec, 0) + (trips - 3) * (db.get(rec, 0) - da.get(rec, 0))
        if n:
            trace.append((rec, n))
    return Walked(trace,
                  b.peak_bytes + (trips - 3) * (b.peak_bytes - a.peak_bytes),
                  b.output_bytes, a.layers + b.layers)


def walk_step(cfg: ModelConfig, shape: InputShape,
              opt_cfg: adamw.AdamWConfig | None = None,
              extrapolate_prefill: bool = True, tm=None, fsdp: bool = True):
    """``(Walked, args)``: the real step of ``shape.kind`` on meta inputs
    at ``shape``; ``args`` the step's arguments (parameters, optimizer
    state, batch / token and state) as meta trees, DTensors on the torch
    mesh ``tm`` where one is given (``fsdp``: the parameters' layout)."""
    if shape.kind == "prefill" and extrapolate_prefill:
        period = _period(cfg)
        trips = cfg.n_layers // period
        if trips > 3 and cfg.arch_type != "audio":
            a, b = (walk_step(dataclasses.replace(cfg, n_layers=k * period),
                              shape, extrapolate_prefill=False, tm=tm,
                              fsdp=fsdp)[0]
                    for k in (2, 3))
            return extrapolate(a, b, trips), _args(cfg, shape)
    args = _args(cfg, shape)
    if tm is not None:
        args = distribute_args(cfg, shape, tm, args, fsdp)
    if shape.kind == "train":
        step = make_train_step(cfg, opt_cfg or adamw.AdamWConfig())
        w = walk(lambda: step(args["params"], args["opt"], args["batch"]),
                 args)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg)
        w = walk(lambda: step(args["params"], args["batch"]), args)
    else:
        step = make_serve_step(cfg)
        w = walk(lambda: step(args["params"], args["token"], args["state"]),
                 args)
    w.layers = (cfg.n_layers,)
    return w, args


def _args(cfg: ModelConfig, shape: InputShape) -> dict:
    params = pipeline.param_specs_struct(cfg)
    if shape.kind == "decode":
        token, state = pipeline.decode_input_specs(cfg, shape)
        return {"params": params, "token": token, "state": state}
    batch = pipeline.train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        batch.pop("labels")
        return {"params": params, "batch": batch}
    return {"params": params, "opt": adamw.init(param_dict(params)),
            "batch": batch}


def distribute_args(cfg: ModelConfig, shape: InputShape, tm, args: dict,
                    fsdp: bool) -> dict:
    """The step's arguments as DTensors on the torch mesh ``tm`` under the
    sharding rules (the parameters replaced in their ``Model``)."""
    mesh = of_torch_mesh(tm)
    pspecs = sharding.param_specs(args["params"], cfg, mesh, fsdp=fsdp)
    out = {"params": sharding.distribute_tree(args["params"], pspecs, tm)}
    if "opt" in args:
        opt = args["opt"]
        out["opt"] = dataclasses.replace(
            opt, m=sharding.distribute_tree(opt.m, pspecs, tm),
            v=sharding.distribute_tree(opt.v, pspecs, tm),
            step=sharding.distribute_tree(opt.step, (), tm))
    if "batch" in args:
        out["batch"] = sharding.distribute_tree(
            args["batch"], sharding.batch_specs(cfg, shape, mesh,
                                                args["batch"]), tm)
    if "token" in args:
        tok = {"t": args["token"]}
        out["token"] = sharding.distribute_tree(
            tok, sharding.batch_specs(cfg, shape, mesh, tok), tm)["t"]
        out["state"] = sharding.distribute_tree(
            args["state"], sharding.serve_state_specs(cfg, shape, mesh,
                                                      args["state"]), tm)
    return out


def argument_bytes(cfg: ModelConfig, shape: InputShape, mesh, args: dict,
                   fsdp: bool) -> float:
    """One device's bytes of the step's arguments under the sharding
    rules."""
    params = args["params"]
    pspecs = sharding.param_specs(params, cfg, mesh, fsdp=fsdp)
    total = sharding.tree_bytes(params, pspecs, mesh)
    if "opt" in args:
        opt = args["opt"]
        total += sharding.tree_bytes(opt.m, pspecs, mesh)
        total += sharding.tree_bytes(opt.v, pspecs, mesh)
        total += opt.step.element_size()
    if "batch" in args:
        total += sharding.tree_bytes(
            args["batch"], sharding.batch_specs(cfg, shape, mesh,
                                                args["batch"]), mesh)
    if "token" in args:
        tok = {"t": args["token"]}
        total += sharding.tree_bytes(
            tok, sharding.batch_specs(cfg, shape, mesh, tok), mesh)
        total += sharding.tree_bytes(
            args["state"], sharding.serve_state_specs(cfg, shape, mesh,
                                                      args["state"]), mesh)
    return float(total)


def dry_run(cfg: ModelConfig, shape: InputShape, mesh: DeviceMesh, *,
            name: str | None = None, serve_tp: bool = False,
            trace_path=None, verbose: bool = True,
            opt_cfg: adamw.AdamWConfig | None = None) -> dict:
    """The roofline row of ``cfg`` at ``shape`` on ``mesh`` (see the
    module's docstring); writes the op trace to ``trace_path`` if
    given."""
    name = name or f"{cfg.name}:{shape.name}"
    chips = mesh.size
    fsdp = not (serve_tp and shape.kind in ("decode", "prefill"))
    t0 = time.perf_counter()
    with shardctx.use_mesh(mesh):
        if mesh.axis_names:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with torch_mesh(mesh) as tm, implicit_replication():
                walked, args = walk_step(cfg, shape, opt_cfg, tm=tm,
                                         fsdp=fsdp)
                del args
            args = _args(cfg, shape)
        else:
            walked, args = walk_step(cfg, shape, opt_cfg)
        arg_b = argument_bytes(cfg, shape, mesh, args, fsdp)
    t_walk = time.perf_counter() - t0
    cost = op_walk.cost_from_records(walked.trace).scaled(chips)
    mem = analysis.memory_record(arg_b, walked.output_bytes,
                                 walked.peak_bytes)
    mf = analysis.model_flops(cfg, shape)
    rf = analysis.Roofline(
        name=name, mesh=mesh.name, chips=chips, hlo_flops=cost.flops,
        hlo_bytes=cost.bytes, coll_bytes=cost.coll_bytes, model_flops=mf,
        bytes_per_chip=mem["peak_gb"] * 1e9)
    row = rf.row()
    row.update({
        "hlo": cost.counts(collectives=chips > 1),
        "bytes_by_op": {k: int(v) for k, v in cost.bytes_by_op.items()},
        "memory": mem,
        "layers_walked": list(walked.layers),
        "ops": sum(n for _, n in walked.trace),
        "walk_s": round(t_walk, 1),
    })
    if trace_path is not None:
        write_trace(trace_path, row, walked.trace)
    if verbose:
        tx = row["t_collective_s"]
        print(f"[{name} @ {mesh.name}] walk {t_walk:.0f}s, {row['ops']} ops"
              f" | args {mem['argument_gb']:.2f}GB temp {mem['temp_gb']:.2f}"
              f"GB | Tc {row['t_compute_s']:.3e} Tm {row['t_memory_s']:.3e} "
              f"Tx {tx:.3e} -> "
              f"{row['bottleneck']} | useful {row['usefulness']:.2f}")
        sys.stdout.flush()
    return row


def trace_path_for(arch: str, shape_name: str, mesh_name: str,
                   tag: str = ""):
    return (results_dir() / "optrace"
            / f"{arch}__{shape_name}__{mesh_name}"
              f"{('__' + tag) if tag else ''}.jsonl.gz")


def write_trace(path, row: dict, trace: list) -> None:
    """The op trace: a header line (the row), then one line a record
    ``{"op", "args", "kwargs", "outs", "n"}``."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        f.write(json.dumps(row) + "\n")
        for (op, a, kw, outs), n in trace:
            f.write(json.dumps({"op": op, "args": a, "kwargs": kw,
                                "outs": outs, "n": n}) + "\n")


def _tuples(x):
    if isinstance(x, list):
        return tuple(_tuples(y) for y in x)
    return x


def read_trace(path) -> tuple[dict, list]:
    """``(row, trace)`` as ``write_trace`` wrote them."""
    with gzip.open(os.fspath(path), "rt") as f:
        row = json.loads(f.readline())
        trace = []
        for line in f:
            r = json.loads(line)
            trace.append(((r["op"], _tuples(r["args"]), _tuples(r["kwargs"]),
                           _tuples(r["outs"])), r["n"]))
    return row, trace


def dryrun_one(arch: str, shape_name: str, mesh: DeviceMesh | None = None,
               verbose: bool = True, serve_tp: bool = False,
               tag: str = "") -> dict:
    mesh = mesh or make_production_mesh()
    return dry_run(configs.get(arch), INPUT_SHAPES[shape_name], mesh,
                   serve_tp=serve_tp, verbose=verbose,
                   trace_path=trace_path_for(arch, shape_name, mesh.name,
                                             tag))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=configs.ARCHS)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="1 (one H100), 16x16 (the default) or 2x16x16")
    ap.add_argument("--serve-tp", action="store_true",
                    help="serving param layout (pure TP) for decode/prefill")
    ap.add_argument("--tag", default="", help="op trace file suffix")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-sharded residual stream (the hints)")
    ap.add_argument("--all", action="store_true",
                    help="all (arch x shape) on the chosen mesh")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)
    # DTensor warns once per new redistribution it plans (an all-gather
    # and chunk for an all-to-all on a CPU group, reductions one mesh
    # dimension at a time); the walk counts what it runs
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    if args.mesh and args.multi_pod:
        ap.error("--mesh and --multi-pod exclude each other")
    mesh = (parse_mesh(args.mesh) if args.mesh
            else make_production_mesh(multi_pod=args.multi_pod))
    if args.all:
        combos = [(a, s) for a in configs.ARCHS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    if args.seq_shard:
        shardctx.set_residual_layout("seq")

    results = []
    t0 = time.perf_counter()
    for arch, shape in combos:
        try:
            row = dryrun_one(arch, shape, mesh, serve_tp=args.serve_tp,
                             tag=args.tag)
        except Exception as e:
            row = {"name": f"{arch}:{shape}", "mesh": mesh.name,
                   "error": f"{type(e).__name__}: {e}"}
            print(f"[{arch} x {shape}] FAILED: {row['error']}")
            traceback.print_exc()
        results.append(row)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    n_fail = sum(1 for r in results if "error" in r)
    print(f"\n{len(results) - n_fail}/{len(results)} combinations dry-run "
          f"successfully ({time.perf_counter() - t0:.0f} s)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
