"""The port's schedulers against the reference's: BSP, priority (and
FIFO), locking, the sequential oracle and the window-shaped dispatch.

Graphs are carried across with ``interop.graph_from_arrays`` so both
packages run on identical storage.  Connected components is integer min
propagation, so it is held bitwise, counts included, on every engine.
PageRank is held bitwise *inside* the port ({batch, bucket} x {kernel,
dense}, and engines against the port's own sequential oracle: every
path rounds each product before its add, slots in order) and to
``rtol = atol = 1e-5`` against the reference, whose combine XLA fuses
into an FMA (ROADMAP C2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.apps import cc as ref_cc
from repro.apps import pagerank as ref_pagerank
from repro.core import exec as ref_exec
from repro.core import sync as ref_sync
from repro.core.coloring import distance2_coloring as ref_distance2_coloring
from repro.core.engine_locking import conflict_winners as ref_conflict_winners
from repro.core.engine_sequential import run_sequential as ref_run_sequential
from repro.core.graph import zipf_edges
from repro.core.update import Consistency as RefConsistency
from repro.core.update import UpdateFn as RefUpdateFn
from repro.profile import fit_cost_model as ref_fit
from repro_torch import api, interop
from repro_torch.apps import cc, pagerank
from repro_torch.core import exec as port_exec
from repro_torch.core import sync as port_sync
from repro_torch.core.coloring import (distance2_coloring, greedy_coloring,
                                       single_color)
from repro_torch.core.engine_locking import (LockingEngine, conflict_winners,
                                             conflict_winners_windowed)
from repro_torch.core.engine_sequential import run_sequential
from repro_torch.core.graph import DataGraph
from repro_torch.core.update import Consistency, UpdateFn, UpdateResult
from repro_torch.profile import fit_cost_model as port_fit
from conftest import random_graph
from torch_parity import reference_arrays

# name -> (scheduler, options, consistency of the CC update)
CC_CASES = {
    "chromatic": ("chromatic", {}, "EDGE"),
    "bsp": ("bsp", {}, "EDGE"),
    "priority": ("priority", {"k_select": 16}, "EDGE"),
    "priority_fifo": ("priority", {"k_select": 16, "fifo": True}, "EDGE"),
    "locking_edge": ("locking", {"max_pending": 16}, "EDGE"),
    "locking_full": ("locking", {"max_pending": 16}, "FULL"),
    "locking_vertex": ("locking", {"max_pending": 16}, "VERTEX"),
}


def _port_graph(ref_graph):
    return interop.graph_from_arrays(*reference_arrays(ref_graph),
                                     device="cpu")


def _cc_update(consistency):
    return UpdateFn(cc.make_update().fn, Consistency[consistency], name="cc")


def _ref_cc_update(consistency):
    return RefUpdateFn(ref_cc.make_update().fn, RefConsistency[consistency],
                       name="cc")


@pytest.fixture(scope="module")
def cc_runs():
    """A 150-vertex Zipf graph (5 width buckets) under CC: the reference
    graph, the port's on the same storage, and the reference's run of
    every case."""
    n = 150
    edges = zipf_edges(n, alpha=2.0, max_deg=48, seed=9)
    g, _, _ = ref_cc.build(edges, n)
    runs = {name: ref_api.run(g, _ref_cc_update(cons), scheduler=sched,
                              **opts)
            for name, (sched, opts, cons) in CC_CASES.items()}
    return dict(n=n, edges=edges, ref=g, port=_port_graph(g), runs=runs)


@pytest.mark.parametrize("name", list(CC_CASES))
def test_cc_matches_reference_bitwise(cc_runs, name):
    """Labels, supersteps, updates and the drained task set equal the
    reference's on every engine, under both launch shapes."""
    sched, opts, cons = CC_CASES[name]
    want = cc_runs["runs"][name]
    assert not want.active_any
    for dispatch in ("bucket", "batch"):
        got = api.run(cc_runs["port"], _cc_update(cons), scheduler=sched,
                      dispatch=dispatch, device="cpu", **opts)
        np.testing.assert_array_equal(got.vertex_data["label"].numpy(),
                                      np.asarray(want.vertex_data["label"]))
        assert (got.superstep, got.n_updates, got.active_any) == (
            int(want.superstep), int(want.n_updates), want.active_any), \
            dispatch
    np.testing.assert_array_equal(
        got.vertex_data["label"].numpy(),
        cc.reference_components(cc_runs["edges"], cc_runs["n"]))


def test_cc_active_and_priority_seed_the_task_set(cc_runs):
    """``active=`` / ``priority=`` start a run from a chosen task set, as
    the reference's ``run`` does: bitwise, counts included."""
    rng = np.random.default_rng(3)
    active = rng.random(cc_runs["n"]) < 0.3
    prio = rng.random(cc_runs["n"]).astype(np.float32)
    for sched, opts in (("priority", {"k_select": 8}),
                        ("locking", {"max_pending": 8}),
                        ("chromatic", {})):
        want = ref_api.run(cc_runs["ref"], _ref_cc_update("EDGE"),
                           scheduler=sched, active=jnp.asarray(active),
                           priority=jnp.asarray(prio), **opts)
        got = api.run(cc_runs["port"], _cc_update("EDGE"), scheduler=sched,
                      active=active, priority=prio, device="cpu", **opts)
        np.testing.assert_array_equal(got.vertex_data["label"].numpy(),
                                      np.asarray(want.vertex_data["label"]))
        assert (got.superstep, got.n_updates) == (int(want.superstep),
                                                  int(want.n_updates)), sched


# ----------------------------------------------------------------------
# The sequential oracle
# ----------------------------------------------------------------------

def _oracle_args(sched, opts):
    """The oracle replay of an engine's RemoveNext."""
    if sched == "priority":
        return {"k_select": opts["k_select"]}
    if sched == "locking":
        return {"locking_pending": opts["max_pending"]}
    if sched == "bsp":
        return {"snapshot_phases": True}
    return {}


@pytest.mark.parametrize("name", [n for n in CC_CASES
                                  if n not in ("priority_fifo",
                                               "locking_vertex")])
def test_cc_engines_equal_the_port_oracle(cc_runs, name):
    """Every engine equals the port's ``run_sequential`` replaying its
    RemoveNext, bitwise and update for update.  (The oracle has no FIFO
    replay, and VERTEX consistency lets neighbours run in one batch,
    which a one-at-a-time replay does not model.)"""
    sched, opts, cons = CC_CASES[name]
    upd = _cc_update(cons)
    got = api.run(cc_runs["port"], upd, scheduler=sched, device="cpu",
                  **opts)
    graph = got.engine.graph           # BSP's is single-colored
    vdata, _, _, n_upd, act = run_sequential(
        graph, upd, max_supersteps=got.superstep, return_active=True,
        **_oracle_args(sched, opts))
    assert torch.equal(vdata["label"], got.vertex_data["label"])
    assert n_upd == got.n_updates and not act.any()


@pytest.mark.parametrize("mode", ["chromatic", "priority", "bsp", "locking"])
def test_pagerank_engines_equal_the_port_oracle(mode):
    """The twin of the reference's ``test_engines_match_sequential_oracle``
    (tests/test_consistency.py), held bitwise: the oracle runs the same
    unfused slot loop at a batch of one, so ranks, the total-rank sync
    and the update counts are equal, not merely close."""
    edges = random_graph(50, 120, seed=3)
    g = pagerank.make_graph(edges, 50, device="cpu")
    syncs = [pagerank.total_rank_sync()]
    if mode == "bsp":
        upd = pagerank.make_update(-1.0)
        st = api.run(g, upd, syncs=syncs, scheduler="bsp",
                     num_supersteps=30, device="cpu")
        replay = dict(snapshot_phases=True, max_supersteps=30)
    else:
        upd = pagerank.make_update(1e-5 if mode == "chromatic" else 1e-6)
        opts = {"priority": {"k_select": 8}, "locking": {"max_pending": 8},
                "chromatic": {}}[mode]
        st = api.run(g, upd, syncs=syncs, scheduler=mode, device="cpu",
                     max_supersteps=5000, **opts)
        assert not st.active_any, "engine must drain tasks"
        replay = dict(_oracle_args(mode, opts), max_supersteps=5000)
    vdata, _, globals_, n_upd = run_sequential(st.engine.graph, upd, syncs,
                                               **replay)
    assert torch.equal(vdata["rank"], st.vertex_data["rank"])
    assert torch.equal(globals_["total_rank"], st.globals["total_rank"])
    assert n_upd == st.n_updates


def _neighbor_writer():
    """An update requiring FULL consistency: it writes neighbour data."""
    def update(scope):
        push = scope.v_data["x"][:, None] * 0.5
        new_nbr = torch.where(scope.nbr_mask, scope.nbr_data["x"] + push,
                              scope.nbr_data["x"])
        return UpdateResult(v_data={"x": scope.v_data["x"] + 1.0},
                            nbr_data={"x": new_nbr})
    return UpdateFn(update, Consistency.FULL, name="pusher")


def test_full_consistency_needs_distance2_coloring():
    """The twin of the reference's test: with a distance-2 coloring the
    chromatic engine equals the oracle (bitwise here); with a distance-1
    coloring a neighbour-writing update diverges from it."""
    edges = random_graph(20, 40, seed=1)
    x0 = np.arange(20, dtype=np.float32)
    upd = _neighbor_writer()

    def run_with(colors):
        g = DataGraph.from_edges(20, edges, {"x": x0},
                                 device="cpu").with_colors(colors)
        st = api.run(g, upd, scheduler="chromatic", num_supersteps=1,
                     device="cpu")
        ref = run_sequential(g, upd, max_supersteps=1)[0]
        return st.vertex_data["x"], ref["x"]

    colors2 = distance2_coloring(20, edges)
    assert np.array_equal(colors2, ref_distance2_coloring(20, edges))
    got2, want2 = run_with(colors2)
    assert torch.equal(got2, want2)
    got1, want1 = run_with(greedy_coloring(20, edges))
    assert not torch.allclose(got1, want1)
    # the locking engine claims whole scopes under FULL: it needs no
    # coloring and equals its own oracle replay
    g = DataGraph.from_edges(20, edges, {"x": x0}, device="cpu")
    st = api.run(g, upd, scheduler="locking", max_pending=6,
                 num_supersteps=4, device="cpu")
    ref = run_sequential(g, upd, locking_pending=6, max_supersteps=4)
    assert torch.equal(st.vertex_data["x"], ref[0]["x"])
    assert st.n_updates == ref[3]


def test_bsp_engine_is_jacobi():
    """Single-color (BSP) execution reads pre-step values: every vertex
    of a path computes from the all-ones ranks."""
    edges = np.asarray([[0, 1], [1, 2]])
    g = pagerank.make_graph(edges, 3, device="cpu")
    st = api.run(g, pagerank.make_update(0.0), scheduler="bsp",
                 num_supersteps=1, device="cpu")
    w = g.edge_data["w"][:-1].double().numpy()
    expect = 0.15 + 0.85 * np.asarray([w[0], w[0] + w[1], w[1]])
    np.testing.assert_allclose(st.vertex_data["rank"].numpy(), expect,
                               rtol=1e-6)
    assert st.engine.graph.n_colors == 1 and st.engine.n_phases == 1


@pytest.fixture(scope="module")
def small_cc():
    """A 40-vertex Zipf graph under CC for the two oracles (the
    reference's replays one task at a time through eager JAX)."""
    n = 40
    edges = zipf_edges(n, alpha=2.0, max_deg=16, seed=2)
    g, _, _ = ref_cc.build(edges, n)
    return g, _port_graph(g)


@pytest.mark.parametrize("replay", ["chromatic", "k_select", "locking",
                                    "locking_full", "snapshot", "until"])
def test_port_oracle_equals_reference_oracle(small_cc, replay):
    """The port's ``run_sequential`` against the reference's on CC:
    labels, update counts and the final task set bitwise (``until``:
    both stop before the superstep whose label-sum sync has fallen
    under half its start)."""
    ref_g, port_g = small_cc
    cons = "FULL" if replay == "locking_full" else "EDGE"
    kw = {"chromatic": {}, "k_select": {"k_select": 8},
          "locking": {"locking_pending": 8},
          "locking_full": {"locking_pending": 8},
          "snapshot": {"snapshot_phases": True}, "until": {}}[replay]
    ref_kw, port_kw = dict(kw), dict(kw)
    if replay == "snapshot":
        ref_g = ref_g.with_colors(single_color(ref_g.n_vertices))
        port_g = port_g.with_colors(single_color(port_g.n_vertices))
    if replay == "until":
        half = 0.5 * float(np.arange(ref_g.n_vertices).sum())
        ref_kw.update(syncs=[ref_sync.sum_sync(
            "total", lambda row: row["label"].astype(jnp.float32))],
            until=lambda glob: float(glob["total"]) < half)
        port_kw.update(syncs=[port_sync.sum_sync(
            "total", lambda row: row["label"].float())],
            until=lambda glob: float(glob["total"]) < half)
    want = ref_run_sequential(ref_g, _ref_cc_update(cons), max_supersteps=50,
                              return_active=True, **ref_kw)
    got = run_sequential(port_g, _cc_update(cons), max_supersteps=50,
                         return_active=True, **port_kw)
    np.testing.assert_array_equal(got[0]["label"].numpy(),
                                  np.asarray(want[0]["label"]))
    assert got[3] == want[3]
    np.testing.assert_array_equal(got[4], np.asarray(want[4]))
    if replay == "until":
        assert got[4].any(), "the predicate should stop the run early"
        assert float(got[2]["total"]) == float(want[2]["total"])


# ----------------------------------------------------------------------
# The window-shaped dispatch
# ----------------------------------------------------------------------

# mode -> (options, run arguments) of the PageRank dispatch runs
PR_MODES = {
    "chromatic": ({}, {"max_supersteps": 200}),
    "bsp": ({}, {"num_supersteps": 8}),
    "priority": ({"k_select": 16}, {"num_supersteps": 120}),
    "locking": ({"max_pending": 16}, {"num_supersteps": 120}),
}


@pytest.fixture(scope="module")
def pr_runs():
    n = 150
    edges = zipf_edges(n, alpha=2.0, max_deg=48, seed=9)
    g = ref_pagerank.make_graph(edges, n)
    assert g.ell.n_buckets >= 3          # several width branches in play
    upd = ref_pagerank.make_update(1e-6)
    runs = {m: ref_api.run(g, upd, scheduler=m, dispatch="bucket", **o, **r)
            for m, (o, r) in PR_MODES.items()}
    return dict(port=_port_graph(g), runs=runs)


@pytest.mark.parametrize("mode", list(PR_MODES))
def test_pagerank_dispatch_paths_bitwise(pr_runs, mode):
    """{batch, bucket} x {kernel, dense}: four bitwise-equal runs per
    engine (the port's twin of tests/test_dispatch.py's invariant), and
    the reference's run within rtol = atol = 1e-5."""
    opts, run_args = PR_MODES[mode]
    upd = pagerank.make_update(1e-6)
    outs = {(d, k): api.run(pr_runs["port"], upd, scheduler=mode,
                            dispatch=d, use_kernel=k, device="cpu",
                            **opts, **run_args)
            for d in ("bucket", "batch") for k in (True, False)}
    ref = outs["bucket", True]
    for key, st in outs.items():
        assert torch.equal(st.vertex_data["rank"], ref.vertex_data["rank"]), key
        assert torch.equal(st.state.active, ref.state.active), key
        assert (st.superstep, st.n_updates) == (ref.superstep,
                                                ref.n_updates), key
    want = pr_runs["runs"][mode]
    assert ref.superstep == int(want.superstep)
    np.testing.assert_allclose(ref.vertex_data["rank"].numpy(),
                               np.asarray(want.vertex_data["rank"]),
                               rtol=1e-5, atol=1e-5)


def test_auto_dispatch_picks_the_window_for_small_windows(pr_runs,
                                                          monkeypatch):
    """A k = 8 window launches window-shaped; a k = Nv window launches
    every bucket's rows (the twin of the reference's threshold test)."""
    g = pr_runs["port"]
    calls = {"batched": 0, "bucketed": 0}
    for key, attr in (("batched", "ell_spmv_batched"),
                      ("bucketed", "ell_spmv_bucketed")):
        real = getattr(port_exec, attr)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(port_exec, attr, counted)
    upd = pagerank.make_update(1e-6)
    api.run(g, upd, scheduler="priority", k_select=8, num_supersteps=1,
            device="cpu")
    assert calls["batched"] and not calls["bucketed"]
    calls.update(batched=0, bucketed=0)
    api.run(g, upd, scheduler="priority", k_select=g.n_vertices,
            num_supersteps=1, device="cpu")
    assert calls["bucketed"] and not calls["batched"]


def test_choose_dispatch_matches_reference():
    for mode in ("auto", "bucket", "batch"):
        for b in (1, 8, 64, 4096):
            for max_deg in (2, 48, 256):
                for slots in (585, 4096, 12_536_090):
                    assert port_exec.choose_dispatch(mode, b, max_deg, slots) \
                        == ref_exec.choose_dispatch(mode, b, max_deg, slots)
    for fn in (port_exec.choose_dispatch, ref_exec.choose_dispatch):
        with pytest.raises(ValueError, match="unknown dispatch"):
            fn("bogus", 8, 2, 100)
    # the reference also spells "auto" as None, and so does the port
    for b in (1, 64, 4096):
        assert port_exec.choose_dispatch(None, b, 48, 4096) \
            == ref_exec.choose_dispatch(None, b, 48, 4096)
    port_exec.validate_dispatch(None)
    # a fitted model moves the choice the same way in both packages
    records = [{"kind": "launch", "mode": "batch", "width": 48, "rows": b,
                "wall_us": 10.0 + 0.5 * b * 48} for b in (4, 64)]
    launches = ((2, 300), (48, 40))
    for b in (1, 8, 64, 4096):
        assert port_exec.choose_dispatch(
            "auto", b, 48, 4096, cost_model=port_fit(records),
            bucket_launches=launches) == ref_exec.choose_dispatch(
            "auto", b, 48, 4096, cost_model=ref_fit(records),
            bucket_launches=launches)


def test_locking_windowed_claim_pass_matches_full_width():
    """The claim pass at the window's snapped width grants the same
    winners as at ``max_deg`` and as the reference's: whole runs are
    bitwise equal, and so is every winner mask of random windows."""
    edges = zipf_edges(120, alpha=2.0, max_deg=32, seed=4)
    ref_g = ref_pagerank.make_graph(edges, 120)
    g = _port_graph(ref_g)
    upd = pagerank.make_update(1e-6)
    a = LockingEngine(g, upd, max_pending=8, dispatch="batch").run(
        num_supersteps=100)
    b = LockingEngine(g, upd, max_pending=8, dispatch="bucket").run(
        num_supersteps=100)
    assert torch.equal(a.vertex_data["rank"], b.vertex_data["rank"])
    assert int(a.n_updates) == int(b.n_updates)
    rng = np.random.default_rng(0)
    for trial in range(4):
        ids = rng.choice(120, size=16, replace=False).astype(np.int32)
        sel = rng.random(16) < 0.8
        for cons in ("FULL", "EDGE", "VERTEX"):
            t_ids, t_sel = torch.from_numpy(ids), torch.from_numpy(sel)
            full = conflict_winners(g, t_ids, t_sel, Consistency[cons])
            win = conflict_winners_windowed(g, t_ids, t_sel,
                                            Consistency[cons])
            want = ref_conflict_winners(ref_g, jnp.asarray(ids),
                                        jnp.asarray(sel), RefConsistency[cons])
            assert torch.equal(full, win), (trial, cons)
            np.testing.assert_array_equal(full.numpy(), np.asarray(want))


def test_window_bucket_matches_reference(pr_runs):
    g = pr_runs["port"]
    ref_ell = ref_pagerank.make_graph(
        zipf_edges(150, alpha=2.0, max_deg=48, seed=9), 150).ell
    rng = np.random.default_rng(1)
    empty = torch.zeros(0, dtype=torch.int32)
    assert g.ell.window_bucket(empty, empty.bool()) == 0
    for size in (1, 8, 64, 150):
        ids = rng.choice(150, size=size, replace=False).astype(np.int32)
        sel = rng.random(size) < 0.7
        want = int(ref_ell.window_bucket(jnp.asarray(ids), jnp.asarray(sel)))
        got = g.ell.window_bucket(torch.from_numpy(ids), torch.from_numpy(sel))
        assert got == want, size


@pytest.mark.parametrize("kind", ["all_equal", "all_minus_inf", "mixed"])
def test_top_k_tie_order_matches_lax_top_k(kind):
    """The first k of a stable descending sort: ``jax.lax.top_k``'s
    order, lower ids first among ties, also when a drained window scores
    -inf everywhere."""
    rng = np.random.default_rng(5)
    n = 97
    score = {"all_equal": np.full(n, 0.5, np.float32),
             "all_minus_inf": np.full(n, -np.inf, np.float32),
             "mixed": np.where(rng.random(n) < 0.3, -np.inf,
                               rng.integers(0, 4, n)).astype(np.float32),
             }[kind]
    for k in (1, 8, 40, n):
        _, want = jax.lax.top_k(jnp.asarray(score), k)
        got = port_exec.stable_top_k(torch.from_numpy(score), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_run_accepts_the_scheduler_options(cc_runs, tmp_path,
                                           monkeypatch):
    g, upd = cc_runs["port"], _cc_update("EDGE")
    assert api.list_schedulers() == ["bsp", "chromatic", "locking",
                                     "priority", "sequential"]
    with pytest.raises(ValueError, match="does not accept"):
        api.run(g, upd, scheduler="chromatic", max_pending=8, device="cpu")
    with pytest.raises(ValueError, match="does not accept"):
        api.run(g, upd, scheduler="locking", k_select=8, device="cpu")
    # until= is ported: a predicate true at the start executes nothing
    res = api.run(g, upd, until=lambda glob: True, device="cpu")
    assert res.superstep == 0 and res.n_updates == 0
    # cost_model= is ported: "measured" with no calibration of this
    # device type says how to make one
    monkeypatch.setenv("REPRO_TORCH_RESULTS_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="calibrate"):
        api.run(g, upd, scheduler="priority", cost_model="measured",
                device="cpu")
    with pytest.raises(ValueError, match="unknown dispatch"):
        api.run(g, upd, dispatch="window", device="cpu")
    uncolored = DataGraph.from_edges(
        3, np.asarray([[0, 1]]), {"label": np.arange(3, dtype=np.int32)},
        device="cpu")
    with pytest.raises(ValueError, match="needs a colored graph"):
        api.run(uncolored, upd, scheduler="priority", device="cpu")
    # the locking and BSP engines need no coloring
    for sched in ("locking", "bsp"):
        res = api.run(uncolored, upd, scheduler=sched, device="cpu")
        assert res.vertex_data["label"].tolist() == [0, 0, 2]
    res = api.run(g, upd, scheduler="locking", max_pending=g.n_vertices,
                  dispatch="auto", device="cpu")
    assert res.engine.resolve_dispatch(g.n_vertices) == "bucket"
