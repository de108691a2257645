"""The port's profiling, fitted cost model and measured width plans
against the reference's ``repro.profile`` and ``repro.core.graph``.

The fit is the reference's numpy code, so the same records must fit
the same coefficients bit for bit (compared with ``==``), the
reference's own ``results/TRACE_cpu.json`` and ``COSTMODEL_cpu.json``
included.  ``choose_dispatch``, ``candidate_width_plans``,
``choose_width_plan`` and ``from_edges(width_policy="measured")`` must
make the reference's choices under the same model, the last one
building bitwise the reference's storage.  A cost model moves the
launch shape only: runs under any model are bitwise the forced arm's.
"""
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.apps import pagerank as ref_pagerank
from repro.core import exec as ref_exec
from repro.core import graph as ref_graph
from repro.core.graph import zipf_edges
from repro.profile import calibrate as ref_calibrate
from repro.profile import model as ref_model
from repro_torch import api, interop
from repro_torch.apps import pagerank
from repro_torch.core import exec as port_exec
from repro_torch.core import graph as port_graph
from repro_torch.core import registry
from repro_torch.core.engine_chromatic import ChromaticEngine
from repro_torch.core.engine_priority import PriorityEngine
from repro_torch.profile import (CostModel, TraceRecorder, fit_cost_model,
                                 load_cost_model, load_trace,
                                 resolve_cost_model)
from repro_torch.profile import calibrate as port_calibrate
from repro_torch.profile import trace as port_trace
from torch_parity import reference_arrays

ROOT = Path(__file__).resolve().parents[1]


def _launch(width, rows, wall_us, **kw):
    return {"kind": "launch", "mode": "batch", "width": width,
            "rows": rows, "wall_us": wall_us, **kw}


def _linear_records(coef, batch_sizes=(4, 16, 64, 256)):
    return [_launch(w, b, a + bb * b * w)
            for w, (a, bb) in coef.items() for b in batch_sizes]


def _noisy_records(seed):
    rng = np.random.default_rng(seed)
    return [_launch(w, b, float(rng.uniform(1, 1000)))
            for w in (2, 8, 32) for b in (4, 16, 64, 256)]


def _cold_records():
    records = _linear_records({8: (100.0, 0.01)})
    records.append(_launch(8, 4, 1e9, cold=True))
    records += [{"kind": "sync", "rows": 100, "wall_us": 50.0 + 0.5 * 100},
                {"kind": "sync", "rows": 400, "wall_us": 50.0 + 0.5 * 400}]
    return records


def _one_sync_records():
    return _linear_records({4: (1.0, 2.0)}, batch_sizes=(4,)) + [
        {"kind": "sync", "rows": 64, "wall_us": 32.0},
        {"kind": "step", "mode": "batch", "width": 16, "rows": 8,
         "wall_us": 5.0, "phases": 1},
        {"kind": "step", "mode": "batch", "width": 16, "rows": 32,
         "wall_us": 9.0, "phases": 2},
        {"kind": "step", "mode": "bucket", "wall_us": 50.0,
         "launches": [[2, 10]]}]


def _reference_trace():
    return json.loads((ROOT / "results" / "TRACE_cpu.json").read_text())


TRACES = {
    "reference_trace": lambda: _reference_trace()["records"],
    "planted": lambda: _linear_records(
        {4: (120.0, 0.02), 16: (150.0, 0.005), 64: (200.0, 0.001)}),
    "noisy0": lambda: _noisy_records(0),
    "noisy5": lambda: _noisy_records(5),
    "cold": _cold_records,
    "one_sync_and_steps": _one_sync_records,
    "empty": lambda: [],
}


def _same_model(port, ref):
    assert port.coef == ref.coef
    assert port.pooled == ref.pooled
    assert port.sync_cost_us == ref.sync_cost_us
    assert port.n_records == ref.n_records
    assert port.device == ref.device


# ----------------------------------------------------------------------
# the fit: bitwise the reference's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TRACES))
def test_fit_is_bitwise_the_reference(name):
    records = TRACES[name]()
    _same_model(fit_cost_model(records, device="dev"),
                ref_model.fit_cost_model(records, device="dev"))
    assert port_trace.SCHEMA_VERSION == 1


def test_fit_of_the_reference_trace_is_its_costmodel_file():
    """The reference's committed trace (21 records) refits, in the port,
    to exactly the coefficients of its committed model."""
    doc = _reference_trace()
    assert len(doc["records"]) == 21
    model = fit_cost_model(doc["records"], device=doc["device"])
    want = json.loads((ROOT / "results" / "COSTMODEL_cpu.json").read_text())
    assert model.to_json() == want
    back = CostModel.load(ROOT / "results" / "COSTMODEL_cpu.json")
    _same_model(back, ref_model.CostModel.load(
        ROOT / "results" / "COSTMODEL_cpu.json"))


@pytest.mark.parametrize("name", sorted(TRACES))
def test_predict_returns_none_where_the_reference_does(name):
    records = TRACES[name]()
    port = fit_cost_model(records)
    ref = ref_model.fit_cost_model(records)
    for w in (1, 2, 3, 4, 8, 16, 29, 32, 62, 64, 128, 256):
        for rows in (0, 1, 7, 64, 4096):
            assert port.predict(w, rows) == ref.predict(w, rows), (w, rows)
    for launches in ([], [(2, 10)], [(2, 10), (8, 3)], [(2, 5), (999, 1)]):
        assert port.predict_launches(launches) == \
            ref.predict_launches(launches)
    assert CostModel().predict(8, 4) is None
    assert CostModel().predict_launches([(8, 4)]) is None


def test_fit_is_monotone_in_slots_under_noise():
    for seed in range(8):
        model = fit_cost_model(_noisy_records(seed))
        for w in (2, 8, 32, 128):
            ts = [model.predict(w, b) for b in (1, 4, 16, 64, 256, 4096)]
            assert all(t is not None and t >= 0 for t in ts), (seed, w)
            assert all(t1 >= t0 for t0, t1 in zip(ts, ts[1:])), (seed, w)


# ----------------------------------------------------------------------
# choose_dispatch: the reference's choices under the same model
# ----------------------------------------------------------------------

class _Force:
    """A cost model that always prices one arm cheaper."""

    def __init__(self, pick):
        self._batch_t = 1.0 if pick == "batch" else 2.0

    def predict(self, width, rows):
        return self._batch_t

    def predict_launches(self, launches):
        return 1.5


MODELS = {
    "none": lambda: (None, None),
    "empty": lambda: (CostModel(), ref_model.CostModel()),
    "planted": lambda: (
        fit_cost_model(TRACES["planted"]()),
        ref_model.fit_cost_model(TRACES["planted"]())),
    "reference_trace": lambda: (
        fit_cost_model(TRACES["reference_trace"]()),
        ref_model.fit_cost_model(TRACES["reference_trace"]())),
    "force_batch": lambda: (_Force("batch"), _Force("batch")),
    "force_bucket": lambda: (_Force("bucket"), _Force("bucket")),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_choose_dispatch_matches_reference(name):
    port_m, ref_m = MODELS[name]()
    launch_sets = (None, ((2, 100), (8, 30), (32, 5)),
                   ((2, 1_594_285), (4, 221_946), (256, 9_892)))
    for mode in (None, "auto", "bucket", "batch"):
        for b in (1, 8, 64, 512, 4096, 32_768):
            for w in (2, 8, 32, 62, 256):
                for slots in (64, 1024, 65_536, 12_536_090):
                    for launches in launch_sets:
                        got = port_exec.choose_dispatch(
                            mode, b, w, slots, cost_model=port_m,
                            bucket_launches=launches)
                        want = ref_exec.choose_dispatch(
                            mode, b, w, slots, cost_model=ref_m,
                            bucket_launches=launches)
                        assert got == want, (mode, b, w, slots, launches)


def test_choose_and_validate_dispatch_share_error_text():
    with pytest.raises(ValueError) as e1:
        port_exec.validate_dispatch("bogus")
    with pytest.raises(ValueError) as e2:
        port_exec.choose_dispatch("bogus", 8, 8, 100)
    assert str(e1.value) == str(e2.value)
    assert "expected one of" in str(e1.value)


@pytest.mark.parametrize("pick", ["batch", "bucket"])
def test_cost_model_is_bitwise_invisible(pick):
    """``dispatch="auto"`` under a model that forces either arm is the
    forced arm's run, bit for bit, counts included."""
    edges = zipf_edges(120, alpha=2.0, max_deg=32, seed=3)
    g = pagerank.make_graph(edges, 120, device="cpu")
    upd = pagerank.make_update(1e-6)
    runs = [(ChromaticEngine(g, upd, dispatch=pick, max_supersteps=200),
             ChromaticEngine(g, upd, dispatch="auto", cost_model=_Force(pick),
                             max_supersteps=200)),
            (PriorityEngine(g, upd, dispatch=pick, k_select=16,
                            max_supersteps=4000),
             PriorityEngine(g, upd, dispatch="auto", cost_model=_Force(pick),
                            k_select=16, max_supersteps=4000))]
    for forced, auto in runs:
        assert auto.resolve_dispatch(16) == pick
        want, got = forced.run(), auto.run()
        assert torch.equal(got.vertex_data["rank"], want.vertex_data["rank"])
        assert int(got.n_updates) == int(want.n_updates)
        assert got.superstep == want.superstep


# ----------------------------------------------------------------------
# measured width plans
# ----------------------------------------------------------------------

WIDTH_GRAPHS = {                 # (n, alpha, max_deg, seed)
    "zipf150": (150, 2.0, 48, 9),
    "zipf600": (600, 2.0, 96, 0),
    "zipf2000": (2000, 1.6, 256, 1),
}


def _slot_counts(n, edges):
    return (np.bincount(edges[:, 0], minlength=n)
            + np.bincount(edges[:, 1], minlength=n))


def _hostile(limit):
    """Wide launches priced out: widths above ``limit`` cost 1e9."""
    coef = {w: ((1e9, 0.0) if w > limit else (0.0, 1.0))
            for w in (2, 4, 8, 16, 32, 64)}
    return (CostModel(coef=dict(coef), pooled=(1e9, 0.0)),
            ref_model.CostModel(coef=dict(coef), pooled=(1e9, 0.0)))


PLAN_MODELS = {
    "hostile8": lambda: _hostile(8),
    "hostile32": lambda: _hostile(32),
    "pooled": lambda: (CostModel(pooled=(3.0, 0.01)),
                       ref_model.CostModel(pooled=(3.0, 0.01))),
    "reference_trace": MODELS["reference_trace"],
    "empty": MODELS["empty"],
}


@pytest.mark.parametrize("model", sorted(PLAN_MODELS))
@pytest.mark.parametrize("name", sorted(WIDTH_GRAPHS))
def test_width_plans_match_reference(name, model):
    n, alpha, cap, seed = WIDTH_GRAPHS[name]
    edges = zipf_edges(n, alpha=alpha, max_deg=cap, seed=seed)
    cnt = _slot_counts(n, edges)
    md = int(cnt.max())
    assert port_graph.candidate_width_plans(cnt, md) == \
        ref_graph.candidate_width_plans(cnt, md)
    port_m, ref_m = PLAN_MODELS[model]()
    assert port_graph.choose_width_plan(cnt, md, port_m) == \
        ref_graph.choose_width_plan(cnt, md, ref_m)


@pytest.mark.parametrize("model", ["hostile8", "hostile32", "pooled",
                                   "reference_trace"])
def test_measured_storage_is_bitwise_the_reference(model):
    """``from_edges(width_policy="measured", cost_model=m)`` picks the
    reference's ladder and stores bitwise the reference's arrays."""
    n, alpha, cap, seed = WIDTH_GRAPHS["zipf600"]
    edges = zipf_edges(n, alpha=alpha, max_deg=cap, seed=seed)
    rng = np.random.default_rng(7)
    vdata = {"x": rng.random(n).astype(np.float32)}
    edata = {"w": rng.random(len(edges)).astype(np.float32)}
    port_m, ref_m = PLAN_MODELS[model]()
    ref = ref_graph.DataGraph.from_edges(n, edges, vdata, edata,
                                         width_policy="measured",
                                         cost_model=ref_m)
    got = port_graph.DataGraph.from_edges(n, edges, vdata, edata,
                                          width_policy="measured",
                                          cost_model=port_m, device="cpu")
    want, want_meta = reference_arrays(ref)
    arrays, meta = interop.graph_to_arrays(got)
    assert meta == want_meta
    assert sorted(arrays) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(arrays[k], want[k], err_msg=k)
    if model == "hostile8":
        assert got.ell.is_split and got.ell.widths[-1] <= 8


def test_measured_policy_without_a_model_is_the_pow2_default(
        tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_RESULTS_DIR", str(tmp_path))
    n = 80
    edges = zipf_edges(n, alpha=2.0, max_deg=16, seed=2)
    vdata = {"x": np.zeros(n, np.float32)}
    edata = {"w": np.ones(len(edges), np.float32)}
    meas = port_graph.DataGraph.from_edges(n, edges, vdata, edata,
                                           width_policy="measured",
                                           device="cpu")
    plain = port_graph.DataGraph.from_edges(n, edges, vdata, edata,
                                            device="cpu")
    assert meas.ell.widths == plain.ell.widths
    assert meas.ell.is_split == plain.ell.is_split
    assert port_graph.choose_width_plan(_slot_counts(n, edges), 16,
                                        CostModel()) is None
    # the persisted calibration is the graph's device type's: a CPU
    # graph reads COSTMODEL_cpu.json, and a hostile one splits it
    _hostile(8)[0].save(tmp_path / "COSTMODEL_cpu.json")
    split = port_graph.DataGraph.from_edges(n, edges, vdata, edata,
                                            width_policy="measured",
                                            device="cpu")
    assert split.ell.is_split and split.ell.widths[-1] <= 8


@pytest.mark.parametrize("kwargs,match", [
    (dict(width_policy="bogus"), "width_policy"),
    (dict(cost_model=CostModel()), "only applies to width_policy"),
    (dict(width_policy="pow2", cost_model=CostModel()),
     "only applies to width_policy"),
    (dict(width_policy="measured", w_cap=8), "chooses the bucket ladder"),
    (dict(width_policy="measured", hub_split=True),
     "chooses the bucket ladder"),
])
def test_width_policy_errors_are_the_reference(kwargs, match):
    """Fault C9: ``cost_model=`` without ``width_policy="measured"``
    raises the reference's ValueError, not a TypeError."""
    n, edges = 20, np.array([[0, 1], [1, 2]])
    vdata = {"x": np.zeros(n, np.float32)}
    edata = {"w": np.ones(2, np.float32)}
    with pytest.raises(ValueError, match=match):
        ref_graph.DataGraph.from_edges(n, edges, vdata, edata, **{
            k: (ref_model.CostModel() if k == "cost_model" else v)
            for k, v in kwargs.items()})
    with pytest.raises(ValueError, match=match):
        port_graph.DataGraph.from_edges(n, edges, vdata, edata,
                                        device="cpu", **kwargs)


# ----------------------------------------------------------------------
# persistence and cost_model= spec forms
# ----------------------------------------------------------------------

def test_save_load_roundtrip_and_results_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_RESULTS_DIR", raising=False)
    assert port_trace.results_dir() == Path("results") / "torch"
    model = fit_cost_model(_linear_records({4: (10.0, 0.5)}),
                           device="testdev")
    model.sync_cost_us = 0.25
    back = CostModel.load(model.save(tmp_path / "m.json"))
    assert back == model
    monkeypatch.setenv("REPRO_TORCH_RESULTS_DIR", str(tmp_path / "alt"))
    assert model.save() == tmp_path / "alt" / "COSTMODEL_testdev.json"
    assert load_cost_model(device="testdev") == model
    rec = TraceRecorder(device="testdev")
    rec.record_launch(mode="batch", width=4, rows=8, wall_us=12.0)
    rec.record_step(mode="bucket", wall_us=3.0, launches=((2, 5),))
    rec.record_sync(rows=16, wall_us=1.0)
    tp = rec.save()
    assert tp == tmp_path / "alt" / "TRACE_testdev.json"
    back_rec = load_trace(tp)
    assert back_rec.device == "testdev" and back_rec.records == rec.records
    # the reference reads the port's trace and model files as its own
    ref_back = ref_model.CostModel.load(tmp_path / "alt" /
                                        "COSTMODEL_testdev.json")
    assert ref_back.coef == model.coef
    assert ref_model.fit_cost_model(back_rec.records).coef == \
        fit_cost_model(rec.records).coef


def test_resolve_cost_model_spec_forms(tmp_path, monkeypatch):
    model = fit_cost_model(_linear_records({4: (10.0, 0.5)}), device="t")
    assert resolve_cost_model(None) is None
    assert resolve_cost_model("static") is None
    assert resolve_cost_model(model) is model
    path = model.save(tmp_path / "COSTMODEL_t.json")
    assert resolve_cost_model(str(path)) == model
    monkeypatch.setenv("REPRO_TORCH_RESULTS_DIR", str(tmp_path / "nothing"))
    with pytest.raises(ValueError, match="calibrate"):
        resolve_cost_model("measured", "cpu")
    model.save(tmp_path / "nothing" / "COSTMODEL_cpu.json")
    assert resolve_cost_model("measured", "cpu") == model
    with pytest.raises(ValueError, match="entry point"):
        resolve_cost_model("no-such-plugin")
    with pytest.raises(ValueError, match="cost_model must be"):
        resolve_cost_model(42)


def test_no_gpu_and_no_device_raises(monkeypatch, tmp_path):
    """``TraceRecorder()`` and ``load_cost_model()`` default to the GPU
    and raise without one rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("REPRO_TORCH_RESULTS_DIR", str(tmp_path))
    for fn in (TraceRecorder, load_cost_model,
               lambda: resolve_cost_model("measured"),
               lambda: port_calibrate.main(["--smoke"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    assert TraceRecorder(device="cpu").device == "cpu"


# ----------------------------------------------------------------------
# plugins
# ----------------------------------------------------------------------

def _fake_eps(monkeypatch, group, name, obj):
    real = registry._iter_entry_points

    def fake(g):
        if g == group:
            return (types.SimpleNamespace(name=name, load=lambda: obj),)
        return real(g)
    monkeypatch.setattr(registry, "_iter_entry_points", fake)


def test_scheduler_plugin_resolves_on_registry_miss(monkeypatch):
    def plugin_factory():
        return lambda graph, update_fn, syncs=None, **kw: ChromaticEngine(
            graph, update_fn, syncs=syncs or (), **kw)
    _fake_eps(monkeypatch, registry.SCHEDULER_PLUGIN_GROUP, "extplugin",
              plugin_factory)
    assert registry.SCHEDULER_PLUGIN_GROUP == "repro_torch.schedulers"
    try:
        entry = registry.get_scheduler("extplugin")
        assert entry.name == "extplugin" and "plugin" in entry.description
        g = pagerank.make_graph(zipf_edges(30, alpha=2.0, max_deg=8, seed=1),
                                30, device="cpu")
        upd = pagerank.make_update(1e-5)
        res = api.run(g, upd, scheduler="extplugin", max_supersteps=100,
                      device="cpu")
        ref = api.run(g, upd, scheduler="chromatic", max_supersteps=100,
                      device="cpu")
        assert torch.equal(res.vertex_data["rank"], ref.vertex_data["rank"])
    finally:
        registry._SCHEDULERS.pop("extplugin", None)


def test_unknown_scheduler_error_unchanged_by_plugins(monkeypatch):
    monkeypatch.setattr(registry, "_iter_entry_points", lambda g: ())
    with pytest.raises(ValueError, match="registered schedulers"):
        registry.get_scheduler("no-such-engine")


def test_cost_model_plugin_resolves_by_name(monkeypatch):
    from repro_torch.profile.model import COST_MODEL_PLUGIN_GROUP
    assert COST_MODEL_PLUGIN_GROUP == "repro_torch.cost_models"
    planted = fit_cost_model(_linear_records({4: (3.0, 0.25)}), device="pl")
    _fake_eps(monkeypatch, COST_MODEL_PLUGIN_GROUP, "labmodel",
              lambda: planted)
    assert resolve_cost_model("labmodel") is planted


def test_distributed_registry_names_a9():
    """A9 is ported: the distributed entries resolve, a taken name
    refuses another factory, and a scheduler without a distributed
    variant or an unknown one raises the reference's messages."""
    entry = registry.get_distributed("locking")
    assert "max_pending" in entry.allowed and "mesh" in entry.allowed
    with pytest.raises(ValueError, match="already registered"):
        registry.register_distributed("locking", object)
    with pytest.raises(ValueError, match="no distributed"):
        registry.get_distributed("priority")
    with pytest.raises(ValueError, match="registered schedulers"):
        registry.get_distributed("no-such-engine")


# ----------------------------------------------------------------------
# calibration
# ----------------------------------------------------------------------

def _keys(records):
    return [(r["kind"], r.get("mode"), r.get("width"), r.get("rows"))
            for r in records]


def test_calibrate_smoke_records_the_reference_keys():
    """``calibrate`` at the smoke sizes and seed records the reference's
    ``(kind, mode, width, rows)`` sequence (the same Zipf ladder, the
    same numpy id windows), and its trace refits to its model."""
    sizes = dict(port_calibrate.SMOKE_SIZES)
    assert sizes == ref_calibrate.SMOKE_SIZES
    assert port_calibrate.FULL_SIZES == ref_calibrate.FULL_SIZES
    sizes["iters"] = 1
    rec, model = port_calibrate.calibrate(emit=lambda *_: None,
                                          device="cpu", **sizes)
    ref_rec, _ = ref_calibrate.calibrate(with_hlo=False,
                                         emit=lambda *_: None, **sizes)
    assert _keys(rec.records) == _keys(ref_rec.records)
    assert rec.device == "cpu" and model.device == "cpu"
    assert not any("hlo" in r for r in rec.records)
    assert all(r["wall_us"] > 0 for r in rec.records)
    steps = [r for r in rec.records if r["kind"] == "step"]
    assert [s["launches"] for s in steps] == \
        [s["launches"] for s in ref_rec.records if s["kind"] == "step"]
    refit = fit_cost_model(rec.records, device=model.device)
    assert refit == model and model.coef


@pytest.mark.parametrize("hub_split", [False, True])
def test_calibrate_graph_on_a_built_graph(hub_split):
    """``calibrate_graph`` on a PageRank graph already built (colored,
    split or not) records a launch point a nonempty bucket and batch
    size, one bucket sweep with the graph's own launches, and the two
    sync points, on the graph's device; its trace refits to its model."""
    n, cap, batches = 400, 32, (4, 16, 64)
    edges = zipf_edges(n, alpha=2.0, max_deg=cap, seed=0)
    g, _, _ = pagerank.build(edges, n, hub_split=hub_split,
                             w_cap=8 if hub_split else None, device="cpu")
    rec, model = port_calibrate.calibrate_graph(g, batches, iters=1,
                                                emit=lambda *_: None)
    nonempty = sum(bool(port_calibrate._bucket_windows(g.ell, b, batches,
                                                       0))
                   for b in range(g.ell.n_buckets))
    kinds = [r["kind"] for r in rec.records]
    assert kinds == ["launch"] * (nonempty * len(batches)) + ["step"] + \
        ["sync"] * 2
    assert rec.records[-3]["launches"] == [[w, r] for w, r in
                                           g.ell.bucket_launches]
    assert rec.device == "cpu" and g.ell.is_split == hub_split
    assert fit_cost_model(rec.records, device="cpu") == model


@pytest.mark.parametrize("seed", [0, 3])
def test_bucket_windows_draw_the_reference_ids(seed):
    n, cap = 400, 32
    ref = ref_pagerank.make_graph(zipf_edges(n, alpha=2.0, max_deg=cap,
                                             seed=seed), n)
    port = interop.graph_from_arrays(*reference_arrays(ref), device="cpu")
    for b in range(ref.ell.n_buckets):
        want = ref_calibrate._bucket_windows(ref.ell, b, (4, 16, 64), seed)
        got = port_calibrate._bucket_windows(port.ell, b, (4, 16, 64), seed)
        assert [B for B, _ in got] == [B for B, _ in want]
        for (_, g_ids), (_, w_ids) in zip(got, want):
            np.testing.assert_array_equal(g_ids.numpy(), np.asarray(w_ids))


def test_calibrate_cli_writes_under_the_port_results_dir(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TORCH_RESULTS_DIR", str(tmp_path))
    assert port_calibrate.main(["--smoke", "--device", "cpu", "--nv", "120",
                                "--cap", "8", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert "records ->" in out and "fitted" in out
    trace = load_trace(tmp_path / "TRACE_cpu.json")
    model = CostModel.load(tmp_path / "COSTMODEL_cpu.json")
    assert fit_cost_model(trace.records, device="cpu") == model
    assert load_cost_model("cpu") == model
