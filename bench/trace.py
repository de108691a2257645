"""The traced part of a run: spans, kernel events and the profiler.

Each instrument wraps named entry points of the port from outside (an
entry is ``"package.module:attribute"`` or ``"package.module:Class.
method"``), runs one job under them and restores them.  Nothing here
names a configuration, a cell or a metric: the metric files declare
which entries they read.
"""
from __future__ import annotations

import contextlib
import importlib
import re
import time
import warnings

OUTSIDE = "host outside the named layers"


def resolve(entry: str):
    """``(owner, attribute)`` of an entry point."""
    module, _, path = entry.partition(":")
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for name in parents:
        owner = getattr(owner, name)
    if not hasattr(owner, attr):
        raise AttributeError(f"{entry}: no attribute {attr!r}")
    return owner, attr


@contextlib.contextmanager
def patched(wrappers):
    """Install ``{entry: make_wrapper(fn) -> fn}`` and restore after."""
    saved = []
    try:
        for entry, make in wrappers.items():
            owner, attr = resolve(entry)
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, make(fn))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def span_job(card, spans: dict, job):
    """Seconds in each labelled layer over one ``job()``, each layer's
    calls bracketed by synchronizes so layers do not overlap (the sum is
    a little more than an unbracketed job); a layer called inside
    another is counted in the outer one.  Returns ``(total_s, {label:
    seconds}, job's result)``.  Copied from ``chip_smoke.py``'s
    ``layer_breakdown`` (commit f7cd5cd)."""
    acc = {label: 0.0 for label in spans}
    depth = [0]

    def timed(label):
        def make(fn):
            def inner(*a, **k):
                if depth[0]:
                    return fn(*a, **k)
                depth[0] += 1
                try:
                    card.synchronize()
                    t0 = time.perf_counter()
                    out = fn(*a, **k)
                    card.synchronize()
                    acc[label] += time.perf_counter() - t0
                finally:
                    depth[0] -= 1
                return out
            return inner
        return make

    wrappers = {e: timed(label) for label, entries in spans.items()
                for e in entries}
    with patched(wrappers):
        card.synchronize()
        t0 = time.perf_counter()
        result = job()
        card.synchronize()
        total = time.perf_counter() - t0
    return total, acc, result


def kernel_job(card, kernels: dict, job):
    """Device seconds between CUDA events around every call of each
    kernel's entry points over one ``job()``, with no synchronize inside
    the brackets, and the least time the same work needs.

    ``kernels`` maps a kernel's name to ``(entries, phase, phase_batch,
    work)``: as a call of its ``phase`` entry starts, ``phase_batch(args,
    kwargs)`` reads what the phase will do, and the kernel's first call
    inside the phase charges ``work(batch)`` -> ``(bytes, flops)``.  Returns ``({name: {"device_s", "calls",
    "bytes", "flops"}}, job's result)``; the bytes and flops are lists,
    one entry a charged phase."""
    events = {name: [] for name in kernels}
    work = {name: [] for name in kernels}
    open_phase = {}            # phase entry -> (batch, charged names)

    def around_phase(entry, batch):
        def make(fn):
            def inner(*a, **k):
                open_phase[entry] = (batch(a, k), set())
                try:
                    return fn(*a, **k)
                finally:
                    del open_phase[entry]
            return inner
        return make

    def around_kernel(name):
        _, phase, _, charge = kernels[name]

        def make(fn):
            def inner(*a, **k):
                if phase in open_phase and name not in open_phase[phase][1]:
                    batch, charged = open_phase[phase]
                    charged.add(name)
                    work[name].append(charge(batch))
                start, end = card.event(), card.event()
                start.record()
                out = fn(*a, **k)
                end.record()
                events[name].append((start, end))
                return out
            return inner
        return make

    wrappers = {}
    for name, (entries, phase, batch, _) in kernels.items():
        wrappers[phase] = around_phase(phase, batch)
        for e in entries:
            wrappers[e] = around_kernel(name)
    with patched(wrappers):
        result = job()
        card.synchronize()
    out = {}
    for name in kernels:
        out[name] = {
            "device_s": sum(card.elapsed_s(s, e) for s, e in events[name]),
            "calls": len(events[name]),
            "bytes": [float(b) for b, _ in work[name]],
            "flops": [float(f) for _, f in work[name]],
        }
    return out, result


def _merged(intervals):
    """Union of ``(start, end)`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def kernel_family(name: str) -> str:
    """A device operation's name without its return type, template
    arguments and parameters, so instantiations of one kernel add up."""
    name = re.sub(r"^(void|std::enable_if<[^>]*>::type)\s+", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def label_gaps(gaps, annotations):
    """``{label: seconds}`` of idle ``gaps`` (``(start, end)`` ns), each
    labelled by the innermost host annotation (``(start, end, label)``,
    properly nested, as one thread's ``record_function`` ranges are)
    open at the gap's middle, ``OUTSIDE`` where none is."""
    out = {}
    anns = sorted(annotations)
    stack, i = [], 0
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (s + e) / 2
        while i < len(anns) and anns[i][0] <= mid:
            while stack and stack[-1][1] <= anns[i][0]:
                stack.pop()
            stack.append(anns[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        label = stack[-1][2] if stack else OUTSIDE
        out[label] = out.get(label, 0.0) + (e - s) / 1e9
    return out


def profile_job(card, labels: dict, job, top: int = 10):
    """One ``job()`` under ``torch.profiler`` with each labelled layer's
    entries annotated (``record_function``, no synchronize).  Returns
    ``(profile, job's result)``; ``profile`` has ``wall_s``, ``busy_s``
    (the union of the device's operations, None where the trace holds
    none), ``ops`` (``[name, seconds]``, the costliest device operations,
    at most ``top``), ``gaps`` (``[label, seconds]``: the device's idle
    time labelled by the layer the host was in at each gap's middle, the
    largest ``top``) and ``counts`` (device events by name).  The device
    events are read from the profiler's raw results, as
    ``chip_smoke.py``'s ``device_busy`` (commit f7cd5cd) reads them:
    ``key_averages()`` first builds an event tree of every host op."""
    from torch.profiler import profile, record_function

    def annotated(label):
        def make(fn):
            def inner(*a, **k):
                with record_function(label):
                    return fn(*a, **k)
            return inner
        return make

    wrappers = {e: annotated(label) for label, entries in labels.items()
                for e in entries}
    job_label = "bench.job"
    with patched(wrappers), warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Warning: Profiler clears events")
        card.synchronize()
        with profile(activities=card.profiler_activities()) as prof:
            t0 = time.perf_counter()
            with record_function(job_label):
                result = job()
                card.synchronize()
            wall = time.perf_counter() - t0
    device = card.device_event_type()
    ops, counts, spans, busy = {}, {}, [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.is_user_annotation():
            if e.device_type() == device:
                continue
            if e.name() == job_label:
                window = (start, end)
            else:
                spans.append((start, end, e.name()))
            continue
        if (e.device_type() != device
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        fam = kernel_family(e.name())
        ops[fam] = ops.get(fam, 0.0) + e.duration_ns() / 1e9
        counts[e.name()] = counts.get(e.name(), 0) + 1
        busy.append((start, end))
    merged = _merged(busy)
    busy_s = sum(e - s for s, e in merged) / 1e9 if merged else None
    gaps = {}
    if merged and window is not None:
        edges = [window[0]] + [x for iv in merged for x in iv] + [window[1]]
        gaps = label_gaps([(s, e) for s, e in zip(edges[0::2], edges[1::2])
                           if e > s], spans)
    profile_rec = {
        "wall_s": wall,
        "busy_s": busy_s,
        "ops": sorted(([n, t] for n, t in ops.items()),
                      key=lambda x: -x[1])[:top],
        "gaps": sorted(([n, t] for n, t in gaps.items()),
                       key=lambda x: -x[1])[:top],
        "counts": counts,
    }
    return profile_rec, result
