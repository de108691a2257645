"""Run one cell of ``BENCHMARK.json`` once and build its result line.

A cell names a configuration and a traffic mix.  The harness finds
every piece by those names:

- ``configs/<config>.json``: the deployment's sizes, source and cuts;
  ``configs/<config>.py``: its adapter, which makes the inputs from the
  seed (``generate``), hands them to the port (``build``), makes the
  job from what it built and the traffic (``job``), keeps what a job
  answered (``answer``), judges the answers against the plain
  reference (``check``), and gives the benchmark's own adjacency for
  the kernels' work counts (``adjacency``);
- ``traffic/<traffic>.json``: the scheduler, the job's ``api.run``
  arguments and how a job stops;
- ``limits/<cell>.json``: the limit of every number ``correct`` compares;
- ``metrics/<metric>.py``: one reader a metric, ``read(rec)`` -> a
  value or None; a per-layer metric's file also declares the layers
  (``SPANS``) or the kernel (``KERNEL``) it reads; a kernel's file
  names the phase entry its work is charged to and gives
  ``phase_batch(args, kwargs)``, read as a phase starts, and
  ``work(batch, ctx)`` -> ``(bytes, flops)`` of that phase.

A job starts from the built graph's initial data; jobs run back to back
until ``seconds`` have passed, and every job's answer is judged once
the window has closed.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import roofline, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names a run may not load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class ForbiddenModules(RuntimeError):
    """The run's process loaded JAX or the JAX package."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    adapter: object
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_module(path: Path):
    """A module from a file (names may hold ``-`` and ``.``)."""
    name = "bench_" + "".join(c if c.isalnum() else "_"
                              for c in str(path.relative_to(HERE)))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _metrics(entries, cell_name, reported=None):
    """The metric entries this cell reports, each with its reader."""
    out = []
    for m in entries:
        cells = m.get("workloads")
        if cells is not None and cell_name not in cells:
            continue
        if cells is None and reported is not None and m["moves"] not in reported:
            continue
        out.append(dict(m, reader=load_module(HERE / "metrics" / f"{m['name']}.py")))
    return out


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = json.loads(spec_path.read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {spec_path.name}: "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = _metrics(spec["end_to_end"], name)
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((ROOT / conf["file"]).read_text()),
        adapter=load_module(HERE / "configs" / f"{w['config']}.py"),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        end_to_end=e2e,
        per_layer=_metrics(spec["per_layer"], name,
                           {m["name"] for m in e2e}))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def make_job(cell, card, built):
    """The cell's job: ``job(**override)`` runs one from the start."""
    return cell.adapter.job(card.torch, cell.config, cell.traffic, built,
                            card.device)


@dataclasses.dataclass
class WorkContext:
    """What a kernel metric's ``work(batch, ctx)`` counts from: the
    run's torch and device, the configuration, its adapter and the
    inputs made from the seed; ``cache`` keeps what the counting derives
    once a run (``roofline.adjacency``)."""
    torch: object
    device: object
    config: dict
    adapter: object
    inputs: dict
    cache: dict = dataclasses.field(default_factory=dict)


def _traced(cell, card, job, inputs, keep):
    """The traced jobs: layer spans, kernel events, the profiler."""
    ctx = WorkContext(card.torch, card.device, cell.config, cell.adapter,
                      inputs)
    spans, kernels, counters = {}, {}, {}
    for m in cell.per_layer:
        reader = m["reader"]
        spans.update(getattr(reader, "SPANS", {}))
        k = getattr(reader, "KERNEL", None)
        if k is not None:
            kernels[k["name"]] = (k["entries"], k["phase"],
                                  reader.phase_batch,
                                  lambda b, f=reader.work: f(b, ctx))
            counters[k["name"]] = (k["counter"], k["trace_name"])
    rec = {}
    t0 = time.perf_counter()
    if spans:
        total, acc, res = trace.span_job(card, spans, job)
        keep(res)
        rec["spans"] = {"total_s": total, "by_label": acc,
                        "job_supersteps": res.superstep}
        del res
        log(f"trace: span job done at {time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"{k} {v:.4f} s" for k, v in acc.items())
            + f" of {total:.4f} s")
    if kernels:
        got, res = trace.kernel_job(card, kernels, job)
        keep(res)
        for k in got.values():
            k["bound_s"] = sum(roofline.least_seconds(b, f)
                               for b, f in zip(k["bytes"], k["flops"]))
        rec["kernels"] = got
        ctx.cache.clear()
        del res
        log(f"trace: kernel job done at {time.perf_counter() - t0:.1f} s")
    labels = dict(spans)
    for name, (entries, *_) in kernels.items():
        labels[name] = entries
    for name, (counter, _) in counters.items():
        owner, attr = trace.resolve(counter)
        setattr(owner, attr, 0)
    prof, res = trace.profile_job(card, labels, job)
    prof["job_supersteps"] = res.superstep
    keep(res)
    log(f"trace: profiled job read at {time.perf_counter() - t0:.1f} s; "
        f"device busy {prof['busy_s']} s of {prof['wall_s']} s")
    for name, t in prof["ops"]:
        log(f"trace: device {t:.6f} s {name[:100]}")
    for name, t in prof["gaps"]:
        log(f"trace: idle {t:.6f} s in {name}")
    for name, (counter, trace_name) in counters.items():
        owner, attr = trace.resolve(counter)
        seen = sum(c for n, c in prof["counts"].items() if trace_name in n)
        log(f"trace: {name}: {seen} device events named *{trace_name}* in "
            f"the profile against {getattr(owner, attr)} launches counted "
            f"({counter})")
    rec["profile"] = prof
    rec["power_limit"] = card.power_limit()
    log(f"trace: card {rec['power_limit']}")
    return rec


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, card,
             started: float | None = None) -> dict:
    """One run of ``cell``; returns the result line as a dict.  Raises
    ``ForbiddenModules`` if JAX or the JAX package is loaded once the
    answers are judged and the metrics read: the last step before the
    line."""
    started = time.perf_counter() if started is None else started
    torch, device = card.torch, card.device
    inputs = cell.adapter.generate(torch, cell.config, seed, device)
    card.synchronize()
    card.free()
    card.reset_peak()
    t0 = time.perf_counter()
    built = cell.adapter.build(torch, cell.config, inputs, device)
    card.synchronize()
    t_build = time.perf_counter() - t0
    job = make_job(cell, card, built)
    warm = job()         # one whole job: every shape the window uses
    card.synchronize()
    del warm
    t_setup = time.perf_counter() - started

    drain = cell.traffic["stop"] == "drain"
    answers, left = [], []

    def keep(res):
        answers.append(cell.adapter.answer(cell.config, res))
        left.append(bool(res.active_any) if drain else False)

    times, steps = [], []
    t0 = time.perf_counter()
    while True:
        t_job = time.perf_counter()
        res = job()
        card.synchronize()
        keep(res)
        steps.append(int(res.superstep))
        now = time.perf_counter()
        times.append(now - t_job)
        del res
        if now - t0 >= seconds:
            break
    window_s = now - t0
    peak = card.peak_bytes()
    log(f"set-up {t_setup:.3f} s (build {t_build:.3f} s); {len(times)} jobs "
        f"in {window_s:.3f} s: " + ", ".join(f"{t:.4f}" for t in times)
        + f" s; superstep counts {steps}; peak {peak} bytes")
    rec = {"setup_seconds": t_setup, "build_seconds": t_build,
           "window_seconds": window_s, "jobs": len(times),
           "window_supersteps": sum(steps), "last_job_supersteps": steps[-1],
           "peak_bytes": peak}
    if traced:
        rec.update(_traced(cell, card, job, inputs, keep))
    del built, job
    gc.collect()
    card.free()

    same = all(_same(answers[0], a) for a in answers[1:])
    t0 = time.perf_counter()
    per_answer = cell.adapter.check(torch, cell.config, cell.traffic, inputs,
                                    answers, device)
    log(f"answers: {len(answers)}, all bitwise equal: {same}; judged in "
        f"{time.perf_counter() - t0:.1f} s")
    for nums, stuck in zip(per_answer, left):
        if drain:
            nums["undrained"] = float(stuck)
    names = sorted({k for nums in per_answer for k in nums})
    missing = [k for k in names if k not in cell.limits]
    if missing:
        raise KeyError(f"no limit for {missing} in limits/{cell.name}.json")
    limit = {k: float(cell.limits[k]["limit"]) for k in names}
    failed = sum(any(not nums[k] <= limit[k] for k in nums)
                 for nums in per_answer)
    checks = {k: {"value": max(nums[k] for nums in per_answer),
                  "limit": limit[k]} for k in names}

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = m["reader"].read(rec)
        if value is None:
            if not traced:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": card.platform, "kind": card.kind, "count": card.count,
           "memory_peak_bytes": peak}
    result = {"correct": failed == 0 and bool(answers),
              "attempted": len(answers), "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        prof = rec["profile"]
        if prof["busy_s"]:
            dev.update(busy_s=prof["busy_s"], window_s=prof["wall_s"])
        dev["power_limit"] = rec["power_limit"]
        result["breakdown"] = {"device_ops": prof["ops"],
                               "idle_gaps": prof["gaps"]}
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"modules loaded: {found}")
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}")
    return result


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)
