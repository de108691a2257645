"""The port's program spans and counters (``repro_torch.profile.trace``:
``tracing()``, ``span``, ``count``).

1. **Off is nothing**: with no ``tracing()`` open a run makes no span,
   and its answer is bitwise the traced run's.
2. **The span tree**: one ``superstep`` a superstep, ``n_phases``
   ``phase`` spans in each, every layer span under the phase whose ids
   it carries.
3. **The counters**: the first superstep's real, gathered and routed
   slots and its fallback phases against counts made independently of
   the executor, on the color-major plan and on split storage.
4. **Host syncs**: a synchronizing-operation warning is charged to the
   innermost span, and the warning state is restored afterwards.
5. **The profiler's clock**: under ``torch.profiler`` the spans are user
   annotations, nested as they ran.
6. **The sink**: span and count records survive ``save`` /
   ``load_trace`` and leave ``fit_cost_model`` as it was.
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.apps import pagerank
from repro_torch.core.graph import zipf_edges
from repro_torch.profile import (TraceRecorder, fit_cost_model, load_trace,
                                 span, tracing)
from repro_torch.profile import trace as trace_mod

N = 160
LAYERS = ("gather", "kernel", "update", "writeback", "reschedule")


@pytest.fixture(scope="module")
def built():
    edges = zipf_edges(N, alpha=2.0, seed=5)
    edges = edges[edges[:, 0] != edges[:, 1]]    # one slot an endpoint
    return edges, pagerank.build(edges, N, device="cpu")


def _run(built, **kw):
    _, (graph, update, syncs) = built
    return api.run(graph, update, syncs=syncs, scheduler="chromatic",
                   device="cpu", **kw)


@pytest.fixture(scope="module")
def traced(built):
    with tracing("cpu") as rec:
        res = _run(built)
    return res, rec


def _spans(rec):
    return [r for r in rec.records if r["kind"] == "span"]


def test_off_records_nothing_and_on_is_bitwise(built, traced, monkeypatch):
    made = []
    monkeypatch.setattr(trace_mod._Span, "__init__",
                        lambda self, *a: made.append(a))
    assert span("phase", superstep=0, phase=0) is span("gather")
    res = _run(built)
    assert made == [] and trace_mod._OPEN is None
    on, _ = traced
    assert res.superstep == on.superstep
    for k in res.vertex_data:
        assert torch.equal(res.vertex_data[k], on.vertex_data[k])
    for k in res.globals:
        assert torch.equal(torch.as_tensor(res.globals[k]),
                           torch.as_tensor(on.globals[k]))


def test_span_tree_is_well_formed(traced):
    res, rec = traced
    spans = _spans(rec)
    by_id = {r["id"]: r for r in spans}
    n_phases = res.engine.n_phases
    steps = [r for r in spans if r["name"] == "superstep"]
    assert [r["superstep"] for r in steps] == list(range(res.superstep))
    jobs = [r for r in spans if r["name"] == "job"]
    assert len(jobs) == 1 and all(r["parent"] == jobs[0]["id"]
                                  for r in steps)
    for s in steps:
        phases = [r for r in spans if r["name"] == "phase"
                  and r["parent"] == s["id"]]
        assert [r["phase"] for r in phases] == list(range(n_phases))
        assert all(r["superstep"] == s["superstep"] for r in phases)
    for r in spans:
        if r["name"] not in LAYERS:
            continue
        p = by_id[r["parent"]]
        while p["name"] != "phase":
            p = by_id[p["parent"]]
        assert (p["superstep"], p["phase"]) == (r["superstep"], r["phase"])
    kernels = {r["kernel"] for r in spans if r["name"] == "kernel"}
    assert kernels == {"ell_spmv_bucketed"}
    s = rec.summary()
    assert s["supersteps"] == res.superstep
    for name, v in s["spans"].items():
        assert v["calls"] == sum(r["name"] == name for r in spans)
        assert v["self_device_s"] <= v["device_s"] + 1e-9
    # a superstep is its children and a little loop overhead
    child = sum(r["device_s"] for r in spans
                if r["parent"] is not None
                and by_id[r["parent"]]["name"] == "superstep")
    assert child <= s["spans"]["superstep"]["device_s"]


@pytest.fixture(scope="module")
def traced_split(built):
    """The same graph with its hubs split (``w_cap`` 8), traced: no
    phase plan, every phase gathered at ``max_deg`` and routed."""
    edges, _ = built
    graph, update, syncs = pagerank.build(edges, N, w_cap=8, device="cpu")
    assert graph.ell.is_split
    with tracing("cpu") as rec:
        res = api.run(graph, update, syncs=syncs, scheduler="chromatic",
                      device="cpu")
    return graph, res, rec


@pytest.mark.parametrize("storage", ["unsplit", "split"])
def test_slot_counters_of_the_first_superstep(built, traced, traced_split,
                                              storage):
    """Unsplit, the phases run on the color-major plan: each row is
    gathered once at its stored width, nothing is routed and no phase
    falls back.  Split, every phase falls back to ``[Cmax, max_deg]``
    gathers and the routing onto the buckets."""
    edges, (graph, _, _) = built
    if storage == "unsplit":
        res, rec = traced
    else:
        graph, res, rec = traced_split
    first = {r["name"]: r["value"] for r in rec.records
             if r["kind"] == "count" and r.get("superstep") == 0}
    stored = int(graph.ell.slots.nbr_mask.sum())
    assert first["slots.real"] == 2 * len(edges) == stored
    eng = res.engine
    cmax = eng._color_ids.shape[1]
    s = rec.summary()["counters"]
    if storage == "unsplit":
        assert first["slots.gathered"] == eng.plan.store.padded_slots
        assert first.get("slots.routed", 0) == 0
        assert first.get("phases.fallback", 0) == 0
        assert s.get("phases.fallback", 0) == 0
    else:
        assert eng.plan is None
        assert first["slots.gathered"] == eng.n_phases * cmax * graph.max_deg
        assert first["slots.routed"] == eng.n_phases * graph.ell.padded_slots
        assert first["phases.fallback"] == eng.n_phases
        assert s["phases.fallback"] == eng.n_phases * res.superstep
    assert s["launches.ell_spmv"] == 0          # the CPU's plain version
    assert s["host_syncs"] == 0


def test_sync_warning_is_charged_to_the_innermost_span():
    filters, shown = list(warnings.filters), warnings.showwarning
    with tracing("cpu") as rec:
        with span("superstep", superstep=0):
            with span("phase", superstep=0, phase=0):
                with span("gather"):
                    for _ in range(3):
                        warnings.warn("called a synchronizing CUDA operation")
                warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("called a synchronizing CUDA operation")
    assert warnings.filters == filters and warnings.showwarning is shown
    by_name = {r["name"]: r["host_syncs"] for r in _spans(rec)}
    assert by_name == {"superstep": 0, "phase": 1, "gather": 3}
    s = rec.summary()
    assert s["counters"]["host_syncs"] == 5
    assert sum(s["sync_sites"].values()) == 5
    assert all("test_torch_trace.py:" in k for k in s["sync_sites"])
    assert sum(v["host_syncs"] for v in s["spans"].values()) == 4
    with pytest.raises(ValueError), tracing("cpu"):
        with span("gather"):
            raise ValueError("inside")
    assert warnings.filters == filters and warnings.showwarning is shown
    assert trace_mod._OPEN is None


def test_spans_nest_as_profiler_annotations(built):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing("cpu"):
            _run(built, num_supersteps=1)
    anns = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]
    names = {n for *_, n in anns}
    assert {"job", "superstep", "phase", "select", "gather", "kernel",
            "update", "writeback", "reschedule", "syncs"} <= names
    phases = [(s, e) for s, e, n in anns if n == "phase"]
    (s0, e0), = [(s, e) for s, e, n in anns if n == "superstep"]
    assert all(s0 <= s and e <= e0 for s, e in phases)
    for s, e, n in anns:
        if n in LAYERS:
            assert any(ps <= s and e <= pe for ps, pe in phases), n


def _launch_records():
    rng = np.random.default_rng(0)
    return [{"kind": "launch", "mode": "batch", "width": w, "rows": b,
             "wall_us": 5.0 + 0.01 * w * b * (1 + 0.01 * rng.random()),
             "cold": False}
            for w in (8, 16, 32) for b in (64, 128, 256, 512)]


def test_span_and_count_records_roundtrip_and_are_not_fit(tmp_path):
    plain = TraceRecorder(device="cpu")
    plain.records = _launch_records()
    with tracing("cpu") as rec:
        with span("superstep", superstep=0):
            with span("kernel", kernel="ell_spmv_bucketed"):
                trace_mod.count("slots.real", torch.tensor(7))
                trace_mod.count("slots.real", 5)
    rec.records = plain.records + rec.records
    back = load_trace(rec.save(tmp_path / "t.json"))
    assert back.records == rec.records
    assert back.summary() == rec.summary()
    assert rec.summary()["counters"]["slots.real"] == 12
    assert {r["kind"] for r in back.records} == {"launch", "span", "count"}
    a, b = fit_cost_model(back.records), fit_cost_model(plain.records)
    assert a.coef == b.coef
