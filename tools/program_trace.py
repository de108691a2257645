#!/usr/bin/env python3
"""One benchmark cell's jobs under the program's own spans and counters
(``repro_torch.profile.tracing``), beside the benchmark's own
instruments, on one GPU.

    python3 tools/program_trace.py [--workload pagerank-zipf.chromatic] \\
        [--seed N] [--jobs 3] [--traced 2] [--json PATH]

(``--workload als-netflix.chromatic`` for ALS.)

Builds the cell as ``bench/run.py`` does (inputs from the seed, the
port's build, one warm job), then runs, in turn:

1. ``--jobs`` untraced jobs, each timed on the host clock to its
   synchronize (the benchmark's ``job_s``), the first ``--traced`` of
   them each followed by a job inside ``tracing()``: the tracer's cost
   when on is each traced job's wall against the untraced one before it;
2. one job under ``bench/trace.py``'s synchronize-bracketed spans (the
   benchmark's ``gather_ms`` / ``reschedule_ms``), for comparison;
3. one job inside ``tracing()`` under ``torch.profiler``: the device's
   idle gaps labelled by the program's spans, and the profiler's count of
   ``ell_spmv`` events against ``launches.ell_spmv`` and
   ``ell_spmv.launches``.

Every job's answer is judged against the plain reference with the
cell's limits.  Prints the layer times a superstep (stream time between
CUDA events, no synchronize), the ``kernel`` spans by their ``kernel``
attribute (``kernel[als_normal_eq]``: ALS's fold), ``host_syncs`` by
span and for each phase of the first superstep against the sync sites
read from the code (on the chromatic engine's color-major plan: the
write-back's two compactions a vertex field, the consume and the
reschedule's ``nonzero``, four a phase for PageRank's one field and ten
for ALS's four; on the routed path: one ``nonzero`` a degree bucket in
the bucket-wise row gather and in the routing, five more a phase) and by
the line that made them, the useful share of the gathered slots (and of
ALS's folded slots, ``als.fold_slots``), the phases that fell back to
the routed path (``phases.fallback``), and how much of each superstep
and phase its child spans cover; ``--json PATH`` writes it all.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# the layers each proposed per-layer metric reads, in the superstep
READS = {
    "gather_span_ms": ("gather",),
    "reschedule_span_ms": ("writeback", "reschedule", "syncs"),
    "solve_span_ms": ("solve",),
}


def per_superstep_ms(rec, names):
    """Device ms a superstep of spans named ``names`` run inside a
    superstep (a span inside another of these names counts once)."""
    spans = [r for r in rec.records if r["kind"] == "span"]
    by_id = {r["id"]: r for r in spans}
    steps = sum(r["name"] == "superstep" for r in spans)
    total = 0.0
    for r in spans:
        if r["name"] not in names or r["superstep"] is None:
            continue
        p = r["parent"]
        while p is not None and by_id[p]["name"] not in names:
            p = by_id[p]["parent"]
        if p is None:
            total += r["device_s"]
    return 1e3 * total / steps if steps else None


def coverage(rec):
    """The least and median share of a span's device time its children
    cover, for ``superstep`` and ``phase`` spans."""
    spans = [r for r in rec.records if r["kind"] == "span"]
    child = {}
    for r in spans:
        if r["parent"] is not None:
            child[r["parent"]] = child.get(r["parent"], 0.0) + r["device_s"]
    out = {}
    for name in ("superstep", "phase"):
        shares = [child.get(r["id"], 0.0) / r["device_s"] for r in spans
                  if r["name"] == name and r["device_s"] > 0]
        if shares:
            out[name] = {"min": min(shares),
                         "median": statistics.median(shares)}
    return out


def phase_syncs(rec):
    """Host syncs of every phase's subtree, ``[(superstep, phase, n)]``."""
    spans = [r for r in rec.records if r["kind"] == "span"]
    by_id = {r["id"]: r for r in spans}
    out = {}
    for r in spans:
        p = r
        while p is not None and p["name"] != "phase":
            p = by_id.get(p["parent"])
        if p is not None:
            key = (p["superstep"], p["phase"])
            out[key] = out.get(key, 0) + r["host_syncs"]
    return [[s, c, n] for (s, c), n in sorted(out.items())]


def sites_read_from_code(engine, n_buckets, n_fields):
    """The host syncs each phase of a superstep makes, as read from the
    code, for an update that writes ``n_fields`` vertex fields (see the
    module's docstring)."""
    plan = getattr(engine, "plan", None)
    if plan is None:
        return [2 * n_buckets + 5] * engine.n_phases
    return [2 * n_fields + 2 if blocks.rows else 0
            for _, _, blocks in plan.phases]


def kernel_spans_ms(rec):
    """Device ms a superstep, calls and host syncs of the ``kernel`` spans,
    by their ``kernel`` attribute (``kernel[name]``)."""
    spans = [r for r in rec.records if r["kind"] == "span"]
    steps = sum(r["name"] == "superstep" for r in spans) or 1
    out = {}
    for r in spans:
        if r["name"] == "kernel":
            k = out.setdefault(f"kernel[{r.get('kernel')}]", {
                "calls": 0, "ms_per_superstep": 0.0, "host_syncs": 0})
            k["calls"] += 1
            k["ms_per_superstep"] += 1e3 * r["device_s"] / steps
            k["host_syncs"] += r["host_syncs"]
    return out


def traced_numbers(rec, sites):
    s = rec.summary()
    c = s["counters"]
    steps = s["supersteps"]
    by_phase = phase_syncs(rec)
    first = [n for st, _, n in by_phase if st == 0]
    return {
        **{k: per_superstep_ms(rec, v) for k, v in READS.items()},
        "host_syncs": c.get("host_syncs", 0) / steps if steps else None,
        "useful_slot_pct": (100.0 * c["slots.real"] / c["slots.gathered"]
                            if c.get("slots.gathered") else None),
        "fold_useful_pct": (100.0 * c["slots.real"] / c["als.fold_slots"]
                            if c.get("als.fold_slots") else None),
        "kernel_spans": kernel_spans_ms(rec),
        "supersteps": steps,
        "spans": s["spans"],
        "counters": c,
        "phases_fallback": c.get("phases.fallback", 0),
        "slots_routed": c.get("slots.routed", 0),
        "host_syncs_by_span": {k: v["host_syncs"]
                               for k, v in s["spans"].items()},
        "host_syncs_by_site": dict(sorted(s["sync_sites"].items(),
                                          key=lambda kv: -kv[1])),
        "host_syncs_outside_spans": c.get("host_syncs", 0) - sum(
            v["host_syncs"] for v in s["spans"].values()),
        "phase_syncs_first_superstep": first,
        "phase_sync_sites_read_from_code": sites,
        "coverage": coverage(rec),
    }


def measure(cell, card, seed, jobs, traced):
    import torch
    from bench import harness
    from bench import trace as btrace
    from repro_torch.profile import tracing
    adapter = cell.adapter
    inputs = adapter.generate(torch, cell.config, seed, card.device)
    built = adapter.build(torch, cell.config, inputs, card.device)
    job = harness.make_job(cell, card, built)
    job()
    card.synchronize()
    answers, out = [], {"workload": cell.name, "seed": seed,
                        "card": card.power_limit()}

    def keep(res):
        answers.append(adapter.answer(cell.config, res))
        answers[-1]["_left"] = bool(res.active_any)

    from repro_torch.kernels.ell_spmv import ell_spmv
    n_buckets = built[0].ell.n_buckets
    n_fields = len(built[0].vertex_data)
    times, runs = [], []
    for i in range(jobs):
        t0 = time.perf_counter()
        res = job()
        card.synchronize()
        times.append(time.perf_counter() - t0)
        keep(res)
        if i >= traced:
            continue
        before = ell_spmv.launches
        t0 = time.perf_counter()
        with tracing(card.device) as rec:
            res = job()
            t_job = time.perf_counter() - t0
        wall = time.perf_counter() - t0
        keep(res)
        nums = traced_numbers(rec, sites_read_from_code(res.engine,
                                                        n_buckets, n_fields))
        nums.update(wall_s=wall, job_wall_s=t_job,
                    ell_spmv_launches=ell_spmv.launches - before)
        runs.append(nums)
    out.update(job_s=times, supersteps=int(res.superstep),
               n_buckets=n_buckets, traced=runs,
               tracer_cost_pct=[100.0 * (r["wall_s"] / t - 1)
                                for r, t in zip(runs, times)])

    spans = {}
    for name in ("gather_ms", "reschedule_ms"):
        spans.update(harness.load_module(
            harness.HERE / "metrics" / f"{name}.py").SPANS)
    total, acc, res = btrace.span_job(card, spans, job)
    keep(res)
    out["bracketed_ms"] = {k: 1e3 * v / res.superstep for k, v in acc.items()}
    out["bracketed_superstep_ms"] = 1e3 * total / res.superstep

    holder = {}

    def traced_job():
        with tracing(card.device) as rec:
            r = job()
        holder["rec"] = rec
        return r

    before = ell_spmv.launches
    prof, res = btrace.profile_job(card, {}, traced_job, top=16)
    keep(res)
    rec = holder["rec"]
    out["profiled"] = {
        "wall_s": prof["wall_s"], "busy_s": prof["busy_s"],
        "idle_pct": (100.0 * (1 - prof["busy_s"] / prof["wall_s"])
                     if prof["busy_s"] else None),
        "idle_gaps_by_span": prof["gaps"], "device_ops": prof["ops"],
        "ell_spmv_device_events": sum(
            c for n, c in prof["counts"].items() if "ell_spmv" in n),
        "ell_spmv_launches": ell_spmv.launches - before,
        "launches_ell_spmv_counter": rec.summary()["counters"].get(
            "launches.ell_spmv"),
        "supersteps": int(res.superstep),
    }

    left = [a.pop("_left") for a in answers]
    per = adapter.check(torch, cell.config, cell.traffic, inputs, answers,
                        card.device)
    if cell.traffic["stop"] == "drain":
        for nums, stuck in zip(per, left):
            nums["undrained"] = float(stuck)
    limit = {k: float(v["limit"]) for k, v in cell.limits.items()}
    out["answers"] = len(per)
    out["correct"] = all(nums[k] <= limit[k] for nums in per for k in nums)
    out["checks"] = {k: max(nums[k] for nums in per) for k in per[0]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="pagerank-zipf.chromatic")
    p.add_argument("--seed", type=int, default=1234567)
    p.add_argument("--jobs", type=int, default=3)
    p.add_argument("--traced", type=int, default=2)
    p.add_argument("--json")
    args = p.parse_args(argv)
    import torch
    from bench import harness
    from bench.card import CudaCard
    cell = harness.load_cell(args.workload)
    card = CudaCard(torch, cell.chips)
    out = measure(cell, card, args.seed, args.jobs, args.traced)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    brief = {k: v for k, v in out.items() if k not in ("traced", "profiled")}
    brief["traced"] = [{k: v for k, v in r.items() if k != "spans"}
                       for r in out["traced"]]
    brief["traced_spans"] = out["traced"][0]["spans"] if out["traced"] else None
    brief["profiled"] = out["profiled"]
    print(json.dumps(brief, indent=1))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
