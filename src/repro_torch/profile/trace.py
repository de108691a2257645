"""Per-launch timing traces: the raw material the cost model fits.

The port of ``repro.profile.trace``: the same flat JSON records and
schema, so a trace from either package loads in the other.  Three
record kinds:

* ``launch`` — one timed ``apply_batch`` at a known shape:
  ``{"kind": "launch", "mode": "batch"|"bucket", "width": W,
  "rows": B, "wall_us": t, "cold": bool}``.  ``width * rows`` is the
  padded slot count the model regresses on.
* ``step`` — one engine superstep from ``api.run(profile=True)``: the
  same fields plus ``"phases"`` and, for bucket-mode steps, a
  ``"launches": [[W_b, rows_b], ...]`` composite instead of a single
  ``width``/``rows`` pair.  Only single-phase batch steps are fit points.
* ``sync`` — one timed row scatter: ``{"kind": "sync", "rows": H,
  "wall_us": t}``; fits the per-row ``sync_cost_us``.

Two more kinds come from the program's own spans and counters, which
the cost-model fit ignores:

* ``span`` — one layer call inside a ``tracing()`` context: ``{"kind":
  "span", "name", "id", "parent", "superstep", "phase", "host_s",
  "device_s", "host_syncs", ...attributes}``;
* ``count`` — one counter's total over a superstep (``"superstep"``,
  ``None`` outside one): ``{"kind": "count", "name", "superstep",
  "value"}``; ``host_syncs`` records with a ``"site"`` (the Python
  ``file:line`` that synchronized) count the same syncs by where they
  happen.

``span(name, **attrs)`` and ``count(name, n)`` are what the executor
calls at its layer boundaries.  With no ``tracing()`` open, ``span``
returns one shared no-op context and ``count`` returns after one flag
test: no events, no allocations, no device work.  Inside ``tracing()``
each span keeps host times from ``time.perf_counter_ns()`` and, on
CUDA, a pair of CUDA events recorded on the current stream with no
synchronize: the layer's time on the stream, the idle gaps it causes
included.  The events are read once, as the context closes.  While a
``torch.profiler`` profile runs, each span also opens a
``record_function`` range of its name, so the profiler's trace puts the
program's spans on its own clock beside the device's operations.

The reference may nest XLA HLO op counts under an ``"hlo"`` key
(``hlo_counts``).  The port has no HLO to walk; its dry run nests the op
walker's counts there (``roofline.op_walk.Cost.counts``, which adds the
collectives' breakdown by kind), and its
launch records carry no ``"hlo"`` key unless a caller hands counts to
``record_launch``.

Artifacts go to ``results/torch/`` (or ``$REPRO_TORCH_RESULTS_DIR``),
never over the reference's ``results/TRACE_cpu.json``.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import sys
import time
import warnings

import torch

from repro_torch.device import resolve_device

SCHEMA_VERSION = 1


def results_dir() -> pathlib.Path:
    """Artifact directory: ``$REPRO_TORCH_RESULTS_DIR`` or
    ``./results/torch``."""
    return pathlib.Path(os.environ.get("REPRO_TORCH_RESULTS_DIR",
                                       os.path.join("results", "torch")))


def hlo_counts(cost) -> dict:
    """Project a cost object (``flops`` / ``bytes`` / ``coll_bytes``
    attributes, and a ``coll_breakdown`` mapping if it has one) onto the
    shared trace schema's ``"hlo"`` dict."""
    d = {"flops": int(cost.flops), "hbm_bytes": int(cost.bytes),
         "coll_bytes": int(cost.coll_bytes)}
    br = getattr(cost, "coll_breakdown", None)
    if br:
        d["coll_breakdown"] = {k: int(v) for k, v in dict(br).items()}
    return d


class TraceRecorder:
    """Append-only launch/step/sync record sink with JSON persistence.
    ``device`` names the trace's device type; ``None`` is the GPU's
    (``resolve_device``: it raises without one)."""

    def __init__(self, device: str | None = None):
        if device is None:
            device = resolve_device(None).type
        self.device = device
        self.records: list[dict] = []

    def record_launch(self, *, mode: str, width: int, rows: int,
                      wall_us: float, cold: bool = False, hlo=None,
                      **extra) -> dict:
        rec = {"kind": "launch", "mode": mode, "width": int(width),
               "rows": int(rows), "wall_us": float(wall_us),
               "cold": bool(cold), **extra}
        if hlo is not None:
            rec["hlo"] = hlo_counts(hlo) if hasattr(hlo, "flops") else hlo
        self.records.append(rec)
        return rec

    def record_step(self, *, mode: str, wall_us: float, rows=None,
                    width=None, launches=None, phases: int = 1,
                    cold: bool = False, **extra) -> dict:
        rec = {"kind": "step", "mode": mode, "wall_us": float(wall_us),
               "phases": int(phases), "cold": bool(cold), **extra}
        if rows is not None:
            rec["rows"] = int(rows)
        if width is not None:
            rec["width"] = int(width)
        if launches is not None:
            rec["launches"] = [[int(w), int(r)] for w, r in launches]
        self.records.append(rec)
        return rec

    def record_sync(self, *, rows: int, wall_us: float,
                    cold: bool = False, **extra) -> dict:
        rec = {"kind": "sync", "rows": int(rows),
               "wall_us": float(wall_us), "cold": bool(cold), **extra}
        self.records.append(rec)
        return rec

    def summary(self) -> dict:
        """The ``span`` and ``count`` records summed: ``{"spans": {name:
        {"calls", "host_s", "device_s", "self_device_s", "host_syncs"}},
        "counters": {name: total}, "sync_sites": {"file:line": n},
        "supersteps": n}``.  A span's
        ``self_device_s`` is its device time less its child spans'; a
        span inside another of its name adds to ``calls`` and its self
        time only, so no time counts twice.  ``host_syncs`` is charged
        to the innermost open span; the counter ``host_syncs`` adds
        those charged to none."""
        spans = [r for r in self.records if r.get("kind") == "span"]
        by_id = {r["id"]: r for r in spans}
        children = {}
        for r in spans:
            if r["parent"] is not None:
                children[r["parent"]] = (children.get(r["parent"], 0.0)
                                         + r["device_s"])
        out, syncs = {}, 0
        for r in spans:
            s = out.setdefault(r["name"], {
                "calls": 0, "host_s": 0.0, "device_s": 0.0,
                "self_device_s": 0.0, "host_syncs": 0})
            s["calls"] += 1
            s["self_device_s"] += r["device_s"] - children.get(r["id"], 0.0)
            s["host_syncs"] += r["host_syncs"]
            syncs += r["host_syncs"]
            p = r["parent"]
            while p is not None and by_id[p]["name"] != r["name"]:
                p = by_id[p]["parent"]
            if p is None:
                s["host_s"] += r["host_s"]
                s["device_s"] += r["device_s"]
        counters, sites = {}, {}
        for r in self.records:
            if r.get("kind") != "count":
                continue
            if "site" in r:
                sites[r["site"]] = sites.get(r["site"], 0) + r["value"]
            else:
                counters[r["name"]] = counters.get(r["name"], 0) + r["value"]
        if spans or "host_syncs" in counters:
            counters["host_syncs"] = counters.get("host_syncs", 0) + syncs
        return {"spans": out, "counters": counters, "sync_sites": sites,
                "supersteps": sum(r["name"] == "superstep" for r in spans)}

    def to_json(self) -> dict:
        return {"schema": SCHEMA_VERSION, "device": self.device,
                "records": self.records}

    def save(self, path: str | os.PathLike | None = None) -> pathlib.Path:
        if path is None:
            path = results_dir() / f"TRACE_{self.device}.json"
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1))
        return path


def load_trace(path: str | os.PathLike) -> TraceRecorder:
    doc = json.loads(pathlib.Path(path).read_text())
    rec = TraceRecorder(device=doc.get("device", "unknown"))
    rec.records = list(doc.get("records", ()))
    return rec


# ----------------------------------------------------------------------
# Program spans and counters
# ----------------------------------------------------------------------

# the text of the warning ``torch.cuda.set_sync_debug_mode("warn")``
# raises at every device-to-host synchronization
SYNC_WARNING = "called a synchronizing CUDA operation"
# the kernels' launch counters (``module:function``), read as deltas
LAUNCH_COUNTERS = {
    "ell_spmv": "repro_torch.kernels.ell_spmv:ell_spmv",
    "als_normal_eq": "repro_torch.kernels.als_normal_eq:als_normal_eq",
    "segment_sum_csr": "repro_torch.kernels.segment_combine:segment_sum_csr",
    "window_attention": "repro_torch.kernels.window_attention:window_attention",
}

_NO_SPAN = contextlib.nullcontext()
_OPEN = None        # the open ``_Tracer``; None while tracing is off


def span(name: str, **attrs):
    """A context around one layer call: a no-op unless a ``tracing()``
    is open.  ``superstep`` / ``phase`` attributes set the ids the span
    and its children run under."""
    if _OPEN is None:
        return _NO_SPAN
    return _Span(_OPEN, name, attrs)


def count(name: str, n=1) -> None:
    """Add ``n`` (a host int or a 0-d device tensor, summed on the
    device) to counter ``name`` of the current superstep."""
    if _OPEN is None:
        return
    _OPEN.add(name, n)


def tracing_on() -> bool:
    """Whether a ``tracing()`` is open: guards a counter whose value
    costs device work to compute."""
    return _OPEN is not None


def _launches() -> dict:
    """The kernels' launch counters now (0 for a kernel whose module is
    not loaded: importing it here would load the kernels)."""
    out = {}
    for name, entry in LAUNCH_COUNTERS.items():
        module, _, fn = entry.partition(":")
        mod = sys.modules.get(module)
        out[name] = int(getattr(getattr(mod, fn), "launches", 0)) if mod else 0
    return out


class _Span:
    __slots__ = ("tracer", "name", "attrs", "rec")

    def __init__(self, tracer, name, attrs):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self):
        self.rec = self.tracer.enter(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        self.tracer.exit(self.rec)
        return False


class _Tracer:
    """The state of one ``tracing()``: the spans in memory, the open
    stack and the counters, each keyed by superstep."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans, self.stack, self.counts, self.sites = [], [], {}, {}
        if self.cuda:
            self.stream = torch.cuda.current_stream(device)

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def enter(self, name, attrs):
        parent = self.stack[-1] if self.stack else None
        step = attrs.pop("superstep", parent["superstep"] if parent else None)
        phase = attrs.pop("phase", parent["phase"] if parent else None)
        rec = {"kind": "span", "name": name, "id": len(self.spans),
               "parent": parent["id"] if parent else None,
               "superstep": step, "phase": phase, **attrs, "host_syncs": 0}
        if torch._C._autograd._profiler_enabled():
            rec["_range"] = torch.autograd.profiler.record_function(name)
            rec["_range"].__enter__()
        self.spans.append(rec)
        self.stack.append(rec)
        rec["_events"] = [self._event()] if self.cuda else None
        rec["_host"] = [time.perf_counter_ns()]
        return rec

    def exit(self, rec):
        rec["_host"].append(time.perf_counter_ns())
        if self.cuda:
            rec["_events"].append(self._event())
        rng = rec.pop("_range", None)
        if rng is not None:
            rng.__exit__(None, None, None)
        self.stack.pop()

    def add(self, name, n):
        key = (name, self.stack[-1]["superstep"] if self.stack else None)
        self.counts[key] = (n if key not in self.counts
                            else self.counts[key] + n)

    def synced(self, site):
        """One device-to-host synchronization at ``site`` (the Python
        ``(file, line)`` that made it), charged to the innermost open
        span."""
        self.sites[site] = self.sites.get(site, 0) + 1
        if self.stack:
            self.stack[-1]["host_syncs"] += 1
        else:
            self.add("host_syncs", 1)

    def records(self, launches: dict) -> list[dict]:
        """The spans and counters as trace records; reads the CUDA
        events (the caller has synchronized)."""
        out = []
        for rec in self.spans:
            (h0, h1), ev = rec.pop("_host"), rec.pop("_events")
            rec["host_s"] = (h1 - h0) / 1e9
            rec["device_s"] = (rec["host_s"] if ev is None
                               else ev[0].elapsed_time(ev[1]) / 1e3)
            out.append(rec)
        for (name, step), v in self.counts.items():
            v = int(v.item()) if isinstance(v, torch.Tensor) else int(v)
            out.append({"kind": "count", "name": name, "superstep": step,
                        "value": v})
        for name, d in launches.items():
            out.append({"kind": "count", "name": f"launches.{name}",
                        "superstep": None, "value": d})
        for (file, line), n in self.sites.items():
            site = "/".join(pathlib.Path(file).parts[-3:]) + f":{line}"
            out.append({"kind": "count", "name": "host_syncs", "site": site,
                        "value": n})
        return out


@contextlib.contextmanager
def tracing(device=None):
    """Record the program's spans and counters while the context is
    open; yields the ``TraceRecorder`` the ``span`` / ``count`` records
    go into as the context closes (``summary()`` sums them).

    On CUDA, ``torch.cuda.set_sync_debug_mode("warn")`` flags every
    device-to-host synchronization and each is charged to the innermost
    open span (``host_syncs``); the mode and the warning filters are
    restored on exit, exceptions included.  Launch counters are the
    deltas of the kernels' ``.launches`` over the context.  The events
    are recorded on the stream current as the context opens.
    ``device`` is the run's device (``None``: the GPU, as
    ``resolve_device``)."""
    global _OPEN
    if _OPEN is not None:
        raise RuntimeError("tracing() is already open")
    device = resolve_device(device)
    recorder = TraceRecorder(device=device.type)
    tracer = _Tracer(device)
    before = _launches()
    mode = torch.cuda.get_sync_debug_mode() if tracer.cuda else None
    with warnings.catch_warnings():
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                tracer.synced((filename, lineno))
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        warnings.filterwarnings("always", SYNC_WARNING)
        _OPEN = tracer
        try:
            if tracer.cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                yield recorder
            finally:
                if tracer.cuda:
                    torch.cuda.set_sync_debug_mode(mode)
        finally:
            _OPEN = None
    if tracer.cuda:
        torch.cuda.synchronize(device)
    after = _launches()
    recorder.records.extend(tracer.records(
        {k: after[k] - before[k] for k in after}))
