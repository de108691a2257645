"""The port's facade (``repro_torch.api``) against the reference's
``repro.api``, mirroring ``tests/test_api.py``.

1. **Facade == direct construction, bit for bit**, for every registered
   scheduler: the facade is a router, never another execution path.
2. **The registry**: the reference's single-device menu, the shared
   keyword validator and its messages, reload idempotency.
3. **The stepping options**: ``until=`` stops where a ``num_supersteps``
   run of the same length ends, ``trace=`` and ``profile=True`` record
   every superstep, and none of them changes a result.

Graphs cross with ``interop`` so both packages run on identical storage.
Connected components is integer min propagation, held bitwise, counts
included.  PageRank is held bitwise inside the port and to ``rtol =
atol = 1e-5`` against the reference, the tolerance of the port's other
PageRank tests (XLA fuses the reference's combine into an FMA).
"""
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.apps import cc as ref_cc
from repro.apps import pagerank as ref_pagerank
from repro.core.graph import zipf_edges
from repro.core.update import Consistency as RefConsistency
from repro.core.update import UpdateFn as RefUpdateFn
from repro_torch import api, interop
from repro_torch.apps import cc, pagerank
from repro_torch.core import registry
from repro_torch.core.engine_bsp import bsp_engine
from repro_torch.core.engine_chromatic import ChromaticEngine
from repro_torch.core.engine_locking import LockingEngine
from repro_torch.core.engine_priority import PriorityEngine
from repro_torch.core.engine_sequential import SequentialEngine, run_sequential
from repro_torch.core.graph import DataGraph
from repro_torch.core.update import Consistency, UpdateFn, UpdateResult
from conftest import random_graph
from torch_parity import reference_arrays
from test_torch_engine import _fma_combine_update

TOL = dict(rtol=1e-5, atol=1e-5)


def _port(ref_graph):
    return interop.graph_from_arrays(*reference_arrays(ref_graph),
                                     device="cpu")


@pytest.fixture(scope="module")
def pr():
    """The reference's 40-vertex PageRank set-up (``test_api._setup``)
    and the port's on the same storage."""
    g = ref_pagerank.make_graph(random_graph(40, 90, seed=3), 40)
    return dict(ref=g, port=_port(g))


def _pr(pr, eps=1e-5):
    return (pr["port"], pagerank.make_update(eps),
            [pagerank.total_rank_sync()])


def _ref_pr(pr, eps=1e-5):
    return (pr["ref"], ref_pagerank.make_update(eps),
            [ref_pagerank.total_rank_sync()])


@pytest.fixture(scope="module")
def ccg():
    n = 150
    edges = zipf_edges(n, alpha=2.0, max_deg=48, seed=9)
    g, _, _ = ref_cc.build(edges, n)
    return dict(n=n, edges=edges, ref=g, port=_port(g))


def _cc(cons="EDGE"):
    return UpdateFn(cc.make_update().fn, Consistency[cons], name="cc")


def _ref_cc(cons="EDGE"):
    return RefUpdateFn(ref_cc.make_update().fn, RefConsistency[cons],
                       name="cc")


def _assert_same(res, st):
    assert torch.equal(res.vertex_data["rank"], st.vertex_data["rank"])
    assert res.n_updates == int(st.n_updates)
    assert res.superstep == int(st.superstep)
    assert torch.equal(res.globals["total_rank"], st.globals["total_rank"])


# ----------------------------------------------------------------------
# 1. facade == direct construction
# ----------------------------------------------------------------------

DIRECT = {
    "chromatic": (dict(max_supersteps=200), 1e-5,
                  lambda g, u, s: ChromaticEngine(
                      g, u, syncs=s, max_supersteps=200).run()),
    "priority": (dict(k_select=8, max_supersteps=5000), 1e-6,
                 lambda g, u, s: PriorityEngine(
                     g, u, syncs=s, k_select=8, max_supersteps=5000).run()),
    "bsp": (dict(num_supersteps=6), -1.0,
            lambda g, u, s: bsp_engine(g, u, syncs=s).run(num_supersteps=6)),
    "locking": (dict(max_pending=8, max_supersteps=5000), 1e-6,
                lambda g, u, s: LockingEngine(
                    g, u, syncs=s, max_pending=8,
                    max_supersteps=5000).run()),
}


@pytest.mark.parametrize("sched", sorted(DIRECT))
def test_facade_bitwise_equals_direct(pr, sched):
    kwargs, eps, direct = DIRECT[sched]
    g, upd, syncs = _pr(pr, eps)
    res = api.run(g, upd, syncs=syncs, scheduler=sched, device="cpu",
                  **kwargs)
    _assert_same(res, direct(g, upd, syncs))
    assert res.state is not None and res.trace is None
    assert res.profile is None and res.stats == {} and res.restarts is None


@pytest.mark.parametrize("sched", sorted(DIRECT))
def test_pagerank_facade_matches_reference(pr, sched):
    kwargs, eps, _ = DIRECT[sched]
    g, upd, syncs = _pr(pr, eps)
    rg, rupd, rsyncs = _ref_pr(pr, eps)
    got = api.run(g, upd, syncs=syncs, scheduler=sched, device="cpu",
                  **kwargs)
    want = ref_api.run(rg, rupd, syncs=rsyncs, scheduler=sched, **kwargs)
    # ranks to the tolerance; near eps an ulp may move the last
    # superstep, so the counts are held bitwise on CC instead
    np.testing.assert_allclose(got.vertex_data["rank"].numpy(),
                               np.asarray(want.vertex_data["rank"]), **TOL)


def test_facade_sequential_equals_oracle_function(pr):
    g, upd, syncs = _pr(pr)
    res = api.run(g, upd, syncs=syncs, scheduler="sequential",
                  max_supersteps=60, device="cpu")
    vd, ed, gl, n = run_sequential(g, upd, syncs=syncs, max_supersteps=60)
    assert torch.equal(res.vertex_data["rank"], vd["rank"])
    assert res.n_updates == n
    assert res.superstep is None       # the oracle does not count steps
    assert res.active_any is False
    assert res.state is None
    assert torch.equal(res.globals["total_rank"], gl["total_rank"])
    assert isinstance(res.engine, SequentialEngine)
    res1 = api.run(g, upd, syncs=syncs, scheduler="sequential",
                   max_supersteps=1, device="cpu")
    assert res1.active_any is True


ORACLE_CASES = {
    "chromatic": {},
    "priority": {"k_select": 16},
    "locking": {"max_pending": 16},
    "bsp_snapshot": {"snapshot_phases": True},
}


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_sequential_oracle_matches_reference_facade(ccg, name):
    """``scheduler="sequential"`` replays each RemoveNext as the
    reference's oracle does: CC bitwise, counts included."""
    opts = ORACLE_CASES[name]
    got = api.run(ccg["port"], _cc(), scheduler="sequential",
                  max_supersteps=50, device="cpu", **opts)
    want = ref_api.run(ccg["ref"], _ref_cc(), scheduler="sequential",
                       max_supersteps=50, **opts)
    np.testing.assert_array_equal(got.vertex_data["label"].numpy(),
                                  np.asarray(want.vertex_data["label"]))
    assert (got.superstep, got.n_updates, got.active_any) == (
        want.superstep, want.n_updates, want.active_any)


def test_sequential_pagerank_matches_reference_facade(pr):
    g, upd, syncs = _pr(pr)
    rg, rupd, rsyncs = _ref_pr(pr)
    got = api.run(g, upd, syncs=syncs, scheduler="sequential",
                  max_pending=8, max_supersteps=30, device="cpu")
    want = ref_api.run(rg, rupd, syncs=rsyncs, scheduler="sequential",
                       max_pending=8, max_supersteps=30)
    np.testing.assert_allclose(got.vertex_data["rank"].numpy(),
                               np.asarray(want.vertex_data["rank"]), **TOL)
    np.testing.assert_allclose(float(got.globals["total_rank"]),
                               float(want.globals["total_rank"]), **TOL)


def test_engine_spec_build_matches_run(pr):
    g, upd, syncs = _pr(pr, 1e-6)
    spec = api.EngineSpec(scheduler="priority", max_supersteps=5000,
                          options={"k_select": 8})
    eng = spec.build(g, upd, syncs)
    assert isinstance(eng, PriorityEngine)
    res = api.run(g, upd, syncs=syncs, scheduler="priority", k_select=8,
                  max_supersteps=5000, device="cpu")
    _assert_same(res, eng.run())
    eng2 = api.build_engine(g, upd, syncs=syncs, scheduler="priority",
                            k_select=8, max_supersteps=5000, device="cpu")
    _assert_same(res, eng2.run())


# ----------------------------------------------------------------------
# 2. the registry and the shared keyword validator
# ----------------------------------------------------------------------

def test_registry_lists_the_reference_single_device_menu():
    assert api.list_schedulers() == ref_api.list_schedulers()
    desc = api.describe_schedulers()
    assert sorted(desc) == api.list_schedulers()
    assert all(desc[n] for n in desc), "every entry documents itself"
    seq = registry.get_scheduler("sequential")
    assert not seq.stepping and seq.shared == ("max_supersteps",)
    assert seq.allowed == frozenset({"max_supersteps", "k_select",
                                     "max_pending", "snapshot_phases"})
    # the reference's shared set less the Pallas interpret switch
    from repro.core.registry import SHARED_KWARGS as REF_SHARED
    assert registry.SHARED_KWARGS == tuple(
        k for k in REF_SHARED if k != "kernel_interpret")


def test_unknown_scheduler_raises_with_menu(pr):
    g, upd, syncs = _pr(pr)
    with pytest.raises(ValueError, match="chromatic"):
        api.run(g, upd, scheduler="chromatik", device="cpu")


@pytest.mark.parametrize("kwargs,match", [
    (dict(scheduler="chromatic", max_pending=8), "max_pending"),
    (dict(scheduler="priority", max_pending=8, k_select=8), "max_pending"),
    (dict(scheduler="bsp", k_select=8), "k_select"),
    (dict(scheduler="locking", k_select=8), "k_select"),
    (dict(scheduler="sequential", use_kernel=False), "use_kernel"),
    (dict(scheduler="sequential", cost_model=lambda: None), "cost_model"),
    (dict(scheduler="chromatic", bogus_knob=1), "bogus_knob"),
    (dict(scheduler="chromatic", exchange_edges=True), "exchange_edges"),
])
def test_inapplicable_kwargs_raise(pr, kwargs, match):
    """Knobs an engine would silently ignore fail loudly, with the
    reference's message (whose allowed set also names the Pallas switch
    ``kernel_interpret``, which the port does not take)."""
    g, upd, syncs = _pr(pr)
    rg, rupd, rsyncs = _ref_pr(pr)
    with pytest.raises(ValueError, match=match) as port_err:
        api.run(g, upd, syncs=syncs, device="cpu", **kwargs)
    if "cost_model" in kwargs:
        return                  # the reference takes a model here
    with pytest.raises(ValueError) as ref_err:
        ref_api.run(rg, rupd, syncs=rsyncs, **kwargs)
    assert str(port_err.value) == str(ref_err.value).replace(
        "'kernel_interpret', ", "")


def test_storage_kwargs_redirect_to_from_edges(pr):
    g, upd, syncs = _pr(pr)
    for kw in (dict(w_cap=8), dict(hub_split=True)):
        with pytest.raises(ValueError, match="from_edges"):
            api.run(g, upd, device="cpu", **kw)


def test_invalid_dispatch_rejected_everywhere(pr):
    g, upd, syncs = _pr(pr)
    with pytest.raises(ValueError, match="dispatch"):
        api.run(g, upd, dispatch="wide", device="cpu")
    with pytest.raises(ValueError, match="dispatch"):
        ChromaticEngine(g, upd, dispatch="wide")
    with pytest.raises(ValueError, match="dispatch"):
        LockingEngine(g, upd, dispatch="wide")


def test_dispatch_none_defers_like_auto(pr):
    """Fault C10: ``dispatch=None`` is the reference's "auto", in the
    facade and at engine construction."""
    g, upd, syncs = _pr(pr, 1e-6)
    runs = [api.run(g, upd, syncs=syncs, scheduler="priority", k_select=8,
                    dispatch=d, max_supersteps=5000, device="cpu")
            for d in (None, "auto")]
    _assert_same(runs[0], runs[1].state)
    assert runs[0].engine.dispatch == "auto"      # the engine's default
    eng = LockingEngine(g, upd, dispatch=None, max_pending=8)
    assert eng.resolve_dispatch(8) == LockingEngine(
        g, upd, max_pending=8).resolve_dispatch(8)
    api.EngineSpec(dispatch=None)


def test_invalid_scalar_knobs_rejected(pr):
    g, upd, syncs = _pr(pr)
    with pytest.raises(ValueError, match="max_pending"):
        api.run(g, upd, scheduler="locking", max_pending=0, device="cpu")
    with pytest.raises(ValueError, match="k_select"):
        api.run(g, upd, scheduler="priority", k_select=-1, device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        api.run(g, upd, n_shards=0, device="cpu")
    with pytest.raises(ValueError, match="k_select"):
        api.run(g, upd, scheduler="priority", k_select=True, device="cpu")
    with pytest.raises(ValueError, match="no distributed"):
        api.run(g, upd, scheduler="priority", n_shards=2, k_select=8,
                device="cpu")
    with pytest.raises(ValueError, match="max_pending"):
        api.build_engine(g, upd, scheduler="locking", max_pending=0,
                         partition=np.zeros(g.n_vertices, np.int64),
                         device="cpu")


@pytest.mark.parametrize("steps", [-1, 0, True])
def test_num_supersteps_edge_values_match_reference(steps):
    """``num_supersteps`` is passed through as the reference passes it:
    -1 and 0 run no superstep, True runs one.  The combine is fused as
    XLA fuses it (fault C2), so the ranks are held bitwise."""
    edges = zipf_edges(60, seed=0)
    rg, rupd, rsyncs = ref_pagerank.build(edges, 60)
    want = ref_api.run(rg, rupd, syncs=rsyncs, num_supersteps=steps)
    got = api.run(_port(rg), _fma_combine_update(1e-4),
                  syncs=[pagerank.total_rank_sync()], num_supersteps=steps,
                  device="cpu")
    assert (got.superstep, got.n_updates) == (want.superstep,
                                              want.n_updates)
    assert got.superstep == int(steps > 0)
    np.testing.assert_array_equal(got.vertex_data["rank"].numpy(),
                                  np.asarray(want.vertex_data["rank"]))


def test_registry_rejects_hijacking_a_taken_name():
    entry = registry.register_scheduler("chromatic", ChromaticEngine)
    assert entry.description, "prior entry returned untouched"
    with pytest.raises(ValueError, match="already registered"):
        registry.register_scheduler("chromatic", lambda *a, **k: None)
    registry.register_scheduler("_lambda_probe", lambda *a, **k: "A")
    try:
        with pytest.raises(ValueError, match="already registered"):
            registry.register_scheduler("_lambda_probe",
                                        lambda *a, **k: "B")
    finally:
        registry._SCHEDULERS.pop("_lambda_probe", None)
    # a reload's new class object of the same strategy is the same one
    fake = type("ChromaticEngine", (), {})
    fake.__module__ = ChromaticEngine.__module__
    assert registry.register_scheduler("chromatic", fake) is entry


def test_colorless_graph_rejected_early_for_color_schedulers():
    edges = random_graph(20, 40, seed=2)
    g = DataGraph.from_edges(20, edges, {"x": np.zeros(20, np.float32)},
                             device="cpu")
    upd = UpdateFn(lambda s: UpdateResult(v_data=s.v_data),
                   Consistency.VERTEX)
    for sched in ("chromatic", "priority"):
        with pytest.raises(ValueError, match="colors"):
            api.build_engine(g, upd, scheduler=sched, device="cpu")
    with pytest.raises(ValueError, match="color"):
        api.run(g, upd, scheduler="sequential", max_supersteps=2,
                device="cpu")
    api.run(g, upd, scheduler="sequential", max_pending=4,
            max_supersteps=2, device="cpu")
    api.build_engine(g, upd, scheduler="locking", max_pending=4,
                     device="cpu")


CONSISTENCY_CASES = ("edge", "vertex", "full", "unsafe")


@pytest.mark.parametrize("cons", CONSISTENCY_CASES)
def test_consistency_override_cc_is_the_reference(ccg, cons):
    """``consistency=`` (the paper's ``set_scope_type``) rewrites the
    update's scope model before the engine sees it: CC under locking
    equals the reference's, bitwise, counts included."""
    got = api.run(ccg["port"], _cc("EDGE"), scheduler="locking",
                  max_pending=16, consistency=cons, device="cpu")
    want = ref_api.run(ccg["ref"], _ref_cc("EDGE"), scheduler="locking",
                       max_pending=16, consistency=cons)
    assert got.engine.update_fn.consistency == Consistency(cons)
    np.testing.assert_array_equal(got.vertex_data["label"].numpy(),
                                  np.asarray(want.vertex_data["label"]))
    assert (got.superstep, got.n_updates) == (want.superstep,
                                              want.n_updates)
    np.testing.assert_array_equal(
        got.vertex_data["label"].numpy(),
        cc.reference_components(ccg["edges"], ccg["n"]))


def test_consistency_override_pagerank(pr):
    g, upd, syncs = _pr(pr)
    rg, rupd, rsyncs = _ref_pr(pr)
    got = api.run(g, upd, syncs=syncs, scheduler="locking",
                  consistency="vertex", max_pending=4, max_supersteps=400,
                  device="cpu")
    want = ref_api.run(rg, rupd, syncs=rsyncs, scheduler="locking",
                       consistency="vertex", max_pending=4,
                       max_supersteps=400)
    assert got.engine.update_fn.consistency == Consistency.VERTEX
    np.testing.assert_allclose(got.vertex_data["rank"].numpy(),
                               np.asarray(want.vertex_data["rank"]), **TOL)
    with pytest.raises(ValueError, match="consistency"):
        api.run(g, upd, consistency="sorta-safe", device="cpu")


# ----------------------------------------------------------------------
# 3. until= / trace= / profile=
# ----------------------------------------------------------------------

@pytest.mark.parametrize("sched,opts", [("chromatic", {}),
                                        ("locking", {"max_pending": 8})])
def test_until_matches_explicit_superstep_run(pr, sched, opts):
    g, upd, syncs = _pr(pr, 1e-6)
    full = api.run(g, upd, syncs=syncs, scheduler=sched, device="cpu",
                   max_supersteps=5000, **opts)
    target = (g.n_vertices + float(full.globals["total_rank"])) / 2
    pred = lambda gl: float(gl["total_rank"]) < target
    res_u = api.run(g, upd, syncs=syncs, scheduler=sched, device="cpu",
                    max_supersteps=5000, until=pred, **opts)
    assert 0 < res_u.superstep < full.superstep, "predicate binds mid-run"
    res_e = api.run(g, upd, syncs=syncs, scheduler=sched, device="cpu",
                    num_supersteps=res_u.superstep, **opts)
    assert torch.equal(res_u.vertex_data["rank"], res_e.vertex_data["rank"])
    assert res_u.n_updates == res_e.n_updates
    res_p = api.run(g, upd, syncs=syncs, scheduler=sched, device="cpu",
                    num_supersteps=res_u.superstep - 1, **opts)
    assert float(res_p.globals["total_rank"]) >= target
    # the reference's facade stops at the same superstep
    rg, rupd, rsyncs = _ref_pr(pr, 1e-6)
    want = ref_api.run(rg, rupd, syncs=rsyncs, scheduler=sched,
                       max_supersteps=5000, until=pred, **opts)
    assert want.superstep == res_u.superstep


def test_until_respects_drain_and_max_supersteps(pr):
    g, upd, syncs = _pr(pr)
    res = api.run(g, upd, syncs=syncs, until=lambda gl: False,
                  max_supersteps=200, device="cpu")
    _assert_same(res, ChromaticEngine(g, upd, syncs=syncs,
                                      max_supersteps=200).run())
    assert not res.active_any


def test_until_on_sequential_oracle(pr):
    g, upd, syncs = _pr(pr)
    rg, rupd, rsyncs = _ref_pr(pr)
    pred = lambda gl: float(gl["total_rank"]) < 48.0
    res = api.run(g, upd, syncs=syncs, scheduler="sequential",
                  max_supersteps=200, until=pred, device="cpu")
    want = ref_api.run(rg, rupd, syncs=rsyncs, scheduler="sequential",
                       max_supersteps=200, until=pred)
    assert float(res.globals["total_rank"]) < 48.0
    assert res.n_updates == want.n_updates
    always = lambda gl: True
    res_s = api.run(g, upd, syncs=syncs, scheduler="sequential",
                    max_supersteps=200, until=always, device="cpu")
    res_e = api.run(g, upd, syncs=syncs, scheduler="chromatic",
                    max_supersteps=200, until=always, device="cpu")
    assert res_s.n_updates == res_e.n_updates == 0


TRACE_CASES = {
    "chromatic": ("chromatic", {}),
    "priority": ("priority", {"k_select": 16}),
    "locking": ("locking", {"max_pending": 16}),
    "bsp": ("bsp", {}),
}


@pytest.mark.parametrize("name", sorted(TRACE_CASES))
def test_trace_records_match_reference(ccg, name):
    """``trace=True`` records one entry a superstep; its counts are the
    reference's, bitwise, and the run is the plain run."""
    sched, opts = TRACE_CASES[name]
    got = api.run(ccg["port"], _cc(), scheduler=sched, trace=True,
                  device="cpu", **opts)
    want = ref_api.run(ccg["ref"], _ref_cc(), scheduler=sched, trace=True,
                       **opts)
    plain = api.run(ccg["port"], _cc(), scheduler=sched, device="cpu",
                    **opts)
    assert len(got.trace) == got.superstep == plain.superstep
    keys = ("superstep", "n_updates", "active")
    assert [[r[k] for k in keys] for r in got.trace] == \
        [[r[k] for k in keys] for r in want.trace]
    assert got.trace[-1]["active"] == 0
    assert torch.equal(got.vertex_data["label"], plain.vertex_data["label"])


def test_trace_globals_and_callables(pr):
    g, upd, syncs = _pr(pr)
    res = api.run(g, upd, syncs=syncs, trace=True, max_supersteps=200,
                  device="cpu")
    assert [r["superstep"] for r in res.trace] == \
        list(range(1, res.superstep + 1))
    last = res.trace[-1]["globals"]["total_rank"]
    assert isinstance(last, np.ndarray)
    assert last == res.globals["total_rank"].numpy()
    res_c = api.run(g, upd, syncs=syncs, num_supersteps=3, device="cpu",
                    trace=lambda st: float(st.vertex_data["rank"][0]))
    assert len(res_c.trace) == 3 and isinstance(res_c.trace[0], float)


def test_trace_false_means_off(pr):
    g, upd, syncs = _pr(pr)
    assert api.run(g, upd, syncs=syncs, trace=False, num_supersteps=2,
                   device="cpu").trace is None
    assert api.run(g, upd, syncs=syncs, scheduler="sequential",
                   trace=False, max_supersteps=2, device="cpu").trace is None
    with pytest.raises(ValueError, match="trace"):
        api.run(g, upd, scheduler="sequential", trace=True, device="cpu")
    with pytest.raises(ValueError, match="profile"):
        api.run(g, upd, scheduler="sequential", profile=True, device="cpu")


PROFILE_CASES = {
    "chromatic": ("chromatic", {}),
    "priority": ("priority", {"k_select": 16}),
    "priority_fifo": ("priority", {"k_select": 16, "fifo": True}),
    "locking": ("locking", {"max_pending": 16}),
    "locking_bucket": ("locking", {"max_pending": 16, "dispatch": "bucket"}),
}
PROBE_KEYS = ("mode", "width", "rows", "launches", "phases", "cold",
              "superstep")


@pytest.mark.parametrize("name", sorted(PROFILE_CASES))
def test_profile_records_match_reference(ccg, name):
    """``profile=True`` steps record the reference's launch shapes
    (mode, width, rows, launches, phases, cold), one a superstep, and
    the profiled run is bitwise the plain one."""
    sched, opts = PROFILE_CASES[name]
    got = api.run(ccg["port"], _cc(), scheduler=sched, profile=True,
                  device="cpu", **opts)
    want = ref_api.run(ccg["ref"], _ref_cc(), scheduler=sched, profile=True,
                       **opts)
    plain = api.run(ccg["port"], _cc(), scheduler=sched, device="cpu",
                    **opts)
    steps = [r for r in got.profile.records if r["kind"] == "step"]
    ref_steps = [r for r in want.profile.records if r["kind"] == "step"]
    assert len(steps) == got.superstep == plain.superstep
    assert [{k: r.get(k) for k in PROBE_KEYS} for r in steps] == \
        [{k: r.get(k) for k in PROBE_KEYS} for r in ref_steps]
    assert steps[0]["cold"] is True and all(r["wall_us"] > 0 for r in steps)
    assert got.profile.device == "cpu"
    assert torch.equal(got.vertex_data["label"], plain.vertex_data["label"])
    assert (got.n_updates, got.active_any) == (plain.n_updates,
                                               plain.active_any)


def test_profile_pagerank_is_bitwise_plain_and_fits(pr):
    from repro_torch.profile import CostModel, fit_cost_model
    g, upd, syncs = _pr(pr, 1e-6)
    # locking's one phase a superstep makes its batch steps fit points
    for sched, opts in (("chromatic", {}), ("priority", {"k_select": 8}),
                        ("locking", {"max_pending": 8})):
        res = api.run(g, upd, syncs=syncs, scheduler=sched, profile=True,
                      max_supersteps=5000, device="cpu", **opts)
        ref = api.run(g, upd, syncs=syncs, scheduler=sched,
                      max_supersteps=5000, device="cpu", **opts)
        _assert_same(res, ref.state)
        model = fit_cost_model(res.profile.records, device="cpu")
        assert isinstance(model, CostModel)
    assert model.coef, "locking's batch steps are fit points"


def test_cost_model_option_stays_bitwise(pr, tmp_path, monkeypatch):
    from repro_torch.profile import fit_cost_model
    g, upd, syncs = _pr(pr, 1e-6)
    records = [{"kind": "launch", "mode": "batch", "width": w, "rows": b,
                "wall_us": 1.0 + 0.01 * b * w}
               for w in (2, 4, 8, 16) for b in (4, 64)]
    model = fit_cost_model(records, device="cpu")
    for sched, opts in (("chromatic", {}), ("priority", {"k_select": 8}),
                        ("locking", {"max_pending": 8})):
        ref = api.run(g, upd, syncs=syncs, scheduler=sched,
                      max_supersteps=5000, device="cpu", **opts)
        got = api.run(g, upd, syncs=syncs, scheduler=sched,
                      max_supersteps=5000, cost_model=model, device="cpu",
                      **opts)
        assert got.engine.cost_model is model
        _assert_same(got, ref.state)
    monkeypatch.setenv("REPRO_TORCH_RESULTS_DIR", str(tmp_path))
    model.save()                          # COSTMODEL_cpu.json
    got = api.run(g, upd, syncs=syncs, scheduler="priority", k_select=8,
                  max_supersteps=5000, cost_model="measured", device="cpu")
    assert got.engine.cost_model == model
    with pytest.raises(ValueError, match="cost_model must be"):
        api.run(g, upd, scheduler="chromatic", cost_model=43, device="cpu")
