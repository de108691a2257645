"""The port's online graph serving (``repro_torch.serve.graph_engine``,
``api.serve``, slack storage in ``core.graph``) against the reference's.

* Storage, bitwise the reference's arrays on the same edges:
  ``from_edges(slack=, edge_capacity=)``, ``insert_edges`` (slack slots
  before and after), ``rebuild_compacted``, ``input_order_edges``; and
  ``dirty_scope_mask``, ``edge_stream``, ``refreshed_weights``.
* Serving: twins of ``tests/test_serve.py``; incremental CC under
  chromatic and locking bitwise the reference's incremental run (labels,
  dirty rows, supersteps, updates) and the port's rebuild; a pinned
  snapshot unchanged by every mutating call and by recomputes (the
  port's tensors are mutable where JAX arrays are not); the sharded arm
  on a small ``LocalMesh``.
"""
import copy

import numpy as np
import pytest
import torch

from conftest import random_graph
from repro import api as ref_api
from repro.apps import cc as ref_cc
from repro.apps import pagerank as ref_pagerank
from repro.core import exec as ref_exec
from repro.core import graph as ref_graph
from repro.data.pipeline import edge_stream as ref_edge_stream
from repro.train import checkpoint as ref_ckpt
from repro_torch import api, interop
from repro_torch.apps import als, cc, pagerank
from repro_torch.core.exec import dirty_scope_mask
from repro_torch.core.graph import (DataGraph, input_order_edges,
                                    insert_edges, rebuild_compacted,
                                    zipf_edges)
from repro_torch.core.mesh import LocalMesh
from repro_torch.core.partition import two_phase_partition
from repro_torch.data.pipeline import edge_stream
from repro_torch.serve.graph_engine import ServingEngine
from torch_parity import reference_arrays

CPU = "cpu"


def _same_storage(ref, port):
    """Every array and meta value of two graphs' exports equal."""
    a, m = reference_arrays(ref)
    b, n = interop.graph_to_arrays(port)
    assert m == n
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def _serve_cc(edges, nv, scheduler="locking", **kw):
    graph, update, _ = cc.build(edges, nv, slack=4, device=CPU)
    if scheduler == "locking":
        kw.setdefault("dispatch", "batch")
        kw.setdefault("max_pending", 32)
        kw.setdefault("max_supersteps", 20_000)
    return api.serve(graph, update, scheduler=scheduler, slack=4,
                     device=CPU, **kw)


def _ref_serve_cc(edges, nv, scheduler="locking", **kw):
    graph, update, _ = ref_cc.build(edges, nv, slack=4)
    if scheduler == "locking":
        kw.setdefault("dispatch", "batch")
        kw.setdefault("max_pending", 32)
        kw.setdefault("max_supersteps", 20_000)
    return ref_api.serve(graph, update, scheduler=scheduler, slack=4, **kw)


def _rebuild_labels(edges, nv, scheduler="locking"):
    g, u, _ = cc.build(edges, nv, device=CPU)
    kw = ({"dispatch": "batch", "max_pending": 32,
           "max_supersteps": 20_000} if scheduler == "locking" else {})
    return api.run(g, u, scheduler=scheduler, device=CPU,
                   **kw).vertex_data["label"].numpy()


# ----------------------------------------------------------------------
# Storage: bitwise the reference's
# ----------------------------------------------------------------------

_SLACKS = [dict(slack=4), dict(slack=1), dict(slack=2, edge_capacity=100)]


@pytest.mark.parametrize("opts", _SLACKS, ids=str)
@pytest.mark.parametrize("locality", [True, False])
def test_slack_storage_insert_and_rebuild_bitwise(opts, locality):
    nv = 50
    edges = random_graph(nv, 90, seed=1)
    w = np.random.default_rng(1).random(len(edges)).astype(np.float32)
    build = dict(vertex_data={"x": np.arange(nv, dtype=np.float32)},
                 edge_data={"w": w}, edge_locality=locality, **opts)
    ref = ref_graph.DataGraph.from_edges(nv, edges, **build)
    port = DataGraph.from_edges(nv, edges, **build, device=CPU)
    _same_storage(ref, port)
    assert port.edge_capacity == ref.edge_capacity
    new = np.asarray([[0, 17], [5, 33], [2, 48], [0, 5]], np.int64)
    data = {"w": np.asarray([0.5, 0.25, 0.125, 1.0], np.float32)}
    ref2, port2 = ref_graph.insert_edges(ref, new, data), \
        insert_edges(port, new, data)
    assert (ref2 is None) == (port2 is None)
    if ref2 is None:             # a row ran out of slack: compact
        ref2 = ref_graph.rebuild_compacted(ref, extra_edges=new,
                                           extra_edge_data=data)
        port2 = rebuild_compacted(port, extra_edges=new,
                                  extra_edge_data=data)
    _same_storage(ref2, port2)
    ein, edata = input_order_edges(port2)
    rein, redata = ref_graph.input_order_edges(ref2)
    assert np.array_equal(ein, rein)
    assert np.array_equal(edata["w"].numpy(), np.asarray(redata["w"]))
    extra = np.asarray([[1, 30], [2, 29]], np.int64)
    _same_storage(ref_graph.rebuild_compacted(ref2, extra_edges=extra),
                  rebuild_compacted(port2, extra_edges=extra))


def test_insert_fills_rows_until_full_as_the_reference():
    """Insert edges at one vertex until its row (then the edge rows) run
    out: every intermediate storage bitwise, the same ``None``."""
    nv = 30
    edges = random_graph(nv, 40, seed=2)
    ref, _, _ = ref_cc.build(edges, nv, slack=2,
                             edge_capacity=len(edges) + 6)
    port, _, _ = cc.build(edges, nv, slack=2, edge_capacity=len(edges) + 6,
                          device=CPU)
    have = {tuple(e) for e in edges.tolist()}
    for v in range(1, nv):
        if (0, v) in have:
            continue
        ref2 = ref_graph.insert_edges(ref, [[0, v]])
        port2 = insert_edges(port, [[0, v]])
        assert (ref2 is None) == (port2 is None)
        if ref2 is None:
            break
        _same_storage(ref2, port2)
        ref, port = ref2, port2
    else:
        pytest.fail("the slack never ran out")


def test_insert_edges_matches_from_scratch_build():
    nv = 50
    edges = random_graph(nv, 90, seed=1)
    new = np.asarray([[0, 17], [5, 33], [2, 48]], np.int64)
    g = pagerank.make_graph(edges, nv, slack=4, device=CPU)
    w_new = {"w": np.asarray([0.5, 0.25, 0.125], np.float32)}
    g2 = insert_edges(g, new, w_new)
    assert g2 is not None and g2.n_edges == len(edges) + 3
    # the original is untouched (snapshot isolation depends on it)
    assert g.n_edges == len(edges)
    ein, edata = input_order_edges(g2)
    assert np.array_equal(ein, np.vstack([edges, new]))
    assert np.array_equal(edata["w"][-3:].numpy(), w_new["w"])
    want = DataGraph.from_edges(nv, np.vstack([edges, new]),
                                vertex_data={"x": np.zeros(nv, np.float32)},
                                device=CPU)
    ids = torch.arange(nv, dtype=torch.int32)
    got, ref = g2.struct_rows(ids), want.struct_rows(ids)
    for v in range(nv):
        assert set(got.nbrs[v][got.nbr_mask[v]].tolist()) == \
            set(ref.nbrs[v][ref.nbr_mask[v]].tolist())


def test_insert_validation():
    nv = 20
    edges = random_graph(nv, 30, seed=0)
    g_noslack, _, _ = cc.build(edges, nv, device=CPU)
    with pytest.raises(ValueError, match="slack"):
        insert_edges(g_noslack, np.asarray([[0, 5]]))
    g, _, _ = cc.build(edges, nv, slack=2, device=CPU)
    with pytest.raises(ValueError, match="self-loop"):
        insert_edges(g, np.asarray([[3, 3]]))
    with pytest.raises(ValueError, match="endpoints"):
        insert_edges(g, np.asarray([[0, nv]]))
    for kw, msg in ((dict(edge_capacity=10), "only applies"),
                    (dict(slack=2, hub_split=True), "incompatible"),
                    (dict(slack=-1), "non-negative"),
                    (dict(slack=2, edge_capacity=3), "capacity must")):
        with pytest.raises(ValueError, match=msg) as got:
            DataGraph.from_edges(nv, edges, {}, device=CPU, **kw)
        with pytest.raises(ValueError) as want:
            ref_graph.DataGraph.from_edges(nv, edges, {}, **kw)
        assert str(got.value) == str(want.value)


def test_compaction_rebuild_preserves_edge_perm_contract():
    nv = 40
    edges = random_graph(nv, 70, seed=5)
    g, _, _ = cc.build(edges, nv, slack=2, device=CPU)
    extra = np.asarray([[1, 30], [2, 29]], np.int64)
    g2 = rebuild_compacted(g, extra_edges=extra)
    ein, _ = input_order_edges(g2)
    assert np.array_equal(ein, np.vstack([edges, extra]))
    assert g2.slack == g.slack and g2.n_edges == len(edges) + 2
    assert np.array_equal(ein[g2.edge_perm], g2.edges_np)


def test_slack_storage_is_bitwise_inert():
    nv = 60
    edges = random_graph(nv, 120, seed=3)
    g0, u0, _ = cc.build(edges, nv, device=CPU)
    g1, u1, _ = cc.build(edges, nv, slack=4, device=CPU)
    assert g1.slack == 4 and g1.edge_capacity > g0.n_edges
    r0 = api.run(g0, u0, scheduler="chromatic", device=CPU)
    r1 = api.run(g1, u1, scheduler="chromatic", device=CPU)
    assert torch.equal(r0.vertex_data["label"], r1.vertex_data["label"])
    assert (r0.superstep, r0.n_updates) == (r1.superstep, r1.n_updates)


def test_dirty_scope_mask_is_the_references():
    nv = 70
    edges = zipf_edges(nv, seed=4)
    ref, _, _ = ref_cc.build(edges, nv, slack=2)
    port, _, _ = cc.build(edges, nv, slack=2, device=CPU)
    for seeds in ([], [0], [3, 3, 17, 60], list(range(0, nv, 7))):
        got = dirty_scope_mask(port, np.asarray(seeds, np.int64))
        want = ref_exec.dirty_scope_mask(ref, np.asarray(seeds, np.int32))
        assert np.array_equal(got.numpy(), np.asarray(want)), seeds


@pytest.mark.parametrize("args", [(200, 6, 11, 5, 2.0), (5000, 300, 0, 3, 1.2),
                                  (3, 2, 5, 4, 2.0)], ids=str)
def test_edge_stream_bitwise_the_references(args):
    n, rate, seed, nb, alpha = args
    got = list(edge_stream(n, rate=rate, seed=seed, n_batches=nb,
                           alpha=alpha))
    want = list(ref_edge_stream(n, rate=rate, seed=seed, n_batches=nb,
                                alpha=alpha))
    assert len(got) == len(want) == nb
    for x, y in zip(got, want):
        assert x.t == y.t
        for a, b in zip(x[1:], y[1:]):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_edge_stream_deterministic_and_wellformed():
    a = list(edge_stream(200, rate=6, seed=11, n_batches=5))
    b = list(edge_stream(200, rate=6, seed=11, n_batches=5))
    assert len(a) == 5
    for x, y in zip(a, b):
        assert (np.array_equal(x.edges, y.edges)
                and np.array_equal(x.touch, y.touch)
                and np.array_equal(x.queries, y.queries))
        assert x.edges.shape[1] == 2
        assert (x.edges[:, 0] != x.edges[:, 1]).all()
        assert len({tuple(sorted(e)) for e in x.edges}) == len(x.edges)


# ----------------------------------------------------------------------
# Serving: incremental == rebuild, and == the reference's incremental run
# ----------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", ["locking", "chromatic"])
def test_incremental_recompute_matches_rebuild_and_reference(scheduler):
    nv = 80
    edges = zipf_edges(nv, seed=7)
    port, ref = _serve_cc(edges, nv, scheduler), \
        _ref_serve_cc(edges, nv, scheduler)
    for s in (port, ref):
        s.recompute()
    new = np.asarray([e for e in [[0, 61], [7, 44], [3, 71]]
                      if port.find_edge(*e) is None]).reshape(-1, 2)
    got = (port.add_edges(new), port.recompute())
    want = (ref.add_edges(new), ref.recompute())
    assert np.array_equal(got[0], want[0])
    assert got[1]["dirty"] > 0
    for key in ("round", "supersteps", "updates", "dirty"):
        assert got[1][key] == want[1][key], key
    inc = port.graph.vertex_data["label"].numpy()
    assert np.array_equal(inc, np.asarray(ref.graph.vertex_data["label"]))
    assert np.array_equal(inc, _rebuild_labels(np.vstack([edges, new]), nv,
                                               scheduler))
    _same_storage(ref.graph, port.graph)


@pytest.mark.parametrize("scheduler", ["locking", "chromatic"])
def test_edge_stream_replay_matches_reference(scheduler):
    """Batches of ``edge_stream`` with label injections, recomputed
    after each: every round's stats and labels the reference's, the end
    the rebuild's."""
    nv = 120
    edges = zipf_edges(nv, seed=3)
    port, ref = _serve_cc(edges, nv, scheduler), \
        _ref_serve_cc(edges, nv, scheduler)
    assert port.recompute() == ref.recompute()
    added, inject = [], -1
    for batch in edge_stream(nv, rate=12, seed=5, n_batches=4):
        fresh = np.asarray([e for e in batch.edges.tolist()
                            if port.find_edge(*e) is None],
                           np.int64).reshape(-1, 2)
        for s in (port, ref):
            s.add_edges(fresh)
            if len(batch.touch):
                s.update_vertex_data(batch.touch[:1], {"label": np.asarray(
                    [inject], np.int32)})
        inject -= 1
        added.extend(fresh.tolist())
        got, want = port.recompute(), ref.recompute()
        assert got == want
        assert np.array_equal(port.read_vertex(batch.queries, "label"),
                              ref.read_vertex(batch.queries, "label"))
    assert port.stats == ref.stats
    assert np.array_equal(port.graph.vertex_data["label"].numpy(),
                          np.asarray(ref.graph.vertex_data["label"]))


def test_locking_dirty_window_launch_trace():
    nv = 100
    edges = zipf_edges(nv, seed=3)
    serving = _serve_cc(edges, nv, "locking", max_pending=32)
    serving.recompute()
    serving.add_edge(0, 55)
    r = serving.recompute(track_launches=True)
    assert r["launches"] and r["launches"] == serving.last_launches
    for launch in r["launches"]:
        assert launch["mode"] == "batch"
        assert launch["rows"] <= 32
    ref = _ref_serve_cc(edges, nv, "locking", max_pending=32)
    ref.recompute()
    ref.add_edge(0, 55)
    want = ref.recompute(track_launches=True)
    assert [(x["rows"], x["width"]) for x in r["launches"]] == \
        [(x["rows"], x["width"]) for x in want["launches"]]
    assert np.array_equal(serving.graph.vertex_data["label"].numpy(),
                          _rebuild_labels(np.vstack([edges, [[0, 55]]]),
                                          nv, "locking"))


def test_vertex_data_update_dirties_and_converges():
    nv = 60
    edges = random_graph(nv, 100, seed=2)
    serving = _serve_cc(edges, nv, "chromatic")
    serving.recompute()
    serving.update_vertex_data([10], {"label": np.asarray([-5], np.int32)})
    r = serving.recompute()
    assert r["dirty"] > 0
    labels = np.arange(nv, dtype=np.int32)
    labels[10] = -5
    assert np.array_equal(serving.graph.vertex_data["label"].numpy(),
                          cc.reference_components(edges, nv, labels=labels))


def test_update_field_validation_and_edge_updates():
    nv = 30
    edges = random_graph(nv, 50, seed=4)
    graph, update, syncs = pagerank.build(edges, nv, slack=4, device=CPU)
    serving = api.serve(graph, update, syncs=syncs, scheduler="chromatic",
                        slack=4, device=CPU)
    serving.recompute()
    with pytest.raises(KeyError, match="rank"):
        serving.update_vertex_data([0], {"nope": np.zeros(1)})
    with pytest.raises(ValueError, match="vertex ids"):
        serving.update_vertex_data([nv], {"rank": np.zeros(1)})
    u, v = int(edges[0][0]), int(edges[0][1])
    with pytest.raises(ValueError, match="already exists"):
        serving.add_edge(u, v)
    serving.update_edge(u, v, w=0.0)
    assert float(serving.snapshot().read_edge(u, v, "w")) != 0.0  # isolated
    serving.recompute()
    assert float(serving.snapshot().read_edge(u, v, "w")) == 0.0
    assert set(serving.snapshot().read_edge(u, v)) == {"w"}


def test_compaction_under_serving_stays_correct():
    nv = 40
    edges = random_graph(nv, 60, seed=6)
    graph, update, _ = cc.build(edges, nv, slack=1,
                                edge_capacity=len(edges) + 4, device=CPU)
    serving = api.serve(graph, update, scheduler="chromatic", device=CPU)
    serving.recompute()
    rng = np.random.default_rng(0)
    added = []
    while serving.stats["compactions"] == 0:
        u, v = int(rng.integers(0, nv)), int(rng.integers(0, nv))
        if u == v or serving.find_edge(u, v) is not None:
            continue
        serving.add_edge(u, v)
        added.append((u, v))
    serving.recompute()
    assert np.array_equal(serving.graph.vertex_data["label"].numpy(),
                          _rebuild_labels(np.vstack([edges, added]), nv,
                                          "chromatic"))
    assert serving.n_edges == len(edges) + len(added)
    assert serving.stats["recolors"] >= 1


def test_online_als_new_rating_reconverges():
    prob = als.synthetic_netflix(12, 10, 3, density=0.3, seed=0, slack=4,
                                 device=CPU)
    graph, update, syncs = als.build(prob)
    serving = api.serve(graph, update, syncs=syncs, scheduler="chromatic",
                        slack=4, device=CPU)
    serving.recompute()
    w_before = serving.graph.vertex_data["w"].numpy().copy()
    rated = {tuple(p) for p in prob.pairs.tolist()}
    u, m = next((u, m) for u in range(prob.n_users)
                for m in range(prob.n_movies) if (u, m) not in rated)
    mv = prob.n_users + m
    serving.add_edge(u, mv, rating=1.5)
    assert serving.recompute()["dirty"] > 0
    w_after = serving.graph.vertex_data["w"].numpy()
    before = float(w_before[u] @ w_before[mv])
    after = float(w_after[u] @ w_after[mv])
    assert abs(after - 1.5) < abs(before - 1.5)
    assert float(serving.snapshot().read_edge(u, mv, "rating")) == 1.5


def test_refreshed_weights_are_the_references():
    nv = 40
    edges = random_graph(nv, 70, seed=9)
    graph, update, syncs = pagerank.build(edges, nv, slack=4, device=CPU)
    port = api.serve(graph, update, syncs=syncs, scheduler="chromatic",
                     device=CPU)
    rg, ru, rs = ref_pagerank.build(edges, nv, slack=4)
    ref = ref_api.serve(rg, ru, syncs=rs, scheduler="chromatic")
    new = np.asarray([[0, 33], [4, 21], [7, 39]], np.int64)
    new = new[[port.find_edge(*e) is None for e in new]]
    zeros = {"w": np.zeros(len(new), np.float32)}
    port.add_edges(new, zeros)
    ref.add_edges(new, zeros)
    touched = np.unique(new.ravel())
    got = pagerank.refreshed_weights(port, touched)
    want = ref_pagerank.refreshed_weights(ref, touched)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1]["w"], want[1]["w"])
    port.update_edge_data(*got)
    ref.update_edge_data(*want)
    assert np.array_equal(port.dirty_mask(), ref.dirty_mask())


# ----------------------------------------------------------------------
# Snapshot isolation under mutable tensors
# ----------------------------------------------------------------------

def _pinned_copy(snap):
    return (copy.deepcopy(snap.vertex_data), copy.deepcopy(snap.edge_data),
            copy.deepcopy(snap.globals), snap.n_edges)


def _unchanged(snap, before):
    vdata, edata, globals_, n_edges = before
    assert snap.n_edges == n_edges
    for got, want in ((snap.vertex_data, vdata), (snap.edge_data, edata)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for k in globals_:
        for a, b in zip(torch.atleast_1d(torch.as_tensor(
                snap.globals[k][0] if isinstance(snap.globals[k], tuple)
                else snap.globals[k])), torch.atleast_1d(torch.as_tensor(
                    globals_[k][0] if isinstance(globals_[k], tuple)
                    else globals_[k]))):
            assert torch.equal(a, b)


_MUTATIONS = {
    "add_edges": lambda s, e: s.add_edges(e),
    "update_vertex_data": lambda s, e: s.update_vertex_data(
        [0, 5], {"rank": np.asarray([7.0, 9.0], np.float32)}),
    "update_edge_data": lambda s, e: s.update_edge_data(
        [0, 1], {"w": np.asarray([3.0, 4.0], np.float32)}),
    "recompute": lambda s, e: s.recompute(full=True),
    "compaction": lambda s, e: [s.add_edge(0, v) for v in range(1, 40)
                                if s.find_edge(0, v) is None],
}


@pytest.mark.parametrize("mutation", sorted(_MUTATIONS))
def test_pinned_snapshot_survives_each_mutation(mutation):
    """A snapshot pinned before a mutating call (then a recompute) reads
    exactly what it read when pinned: no call writes a tensor it holds."""
    nv = 40
    edges = random_graph(nv, 60, seed=12)
    graph, update, syncs = pagerank.build(edges, nv, slack=1,
                                          edge_capacity=len(edges) + 8,
                                          device=CPU)
    serving = api.serve(graph, update, syncs=syncs, scheduler="chromatic",
                        device=CPU)
    serving.recompute()
    pinned = serving.snapshot()
    before = _pinned_copy(pinned)
    ranks = pinned.read_vertex(np.arange(nv), "rank").copy()
    new = np.asarray([e for e in [[0, 33], [4, 21], [7, 39]]
                      if serving.find_edge(*e) is None]).reshape(-1, 2)
    _MUTATIONS[mutation](serving, new)
    serving.recompute()
    _unchanged(pinned, before)
    assert np.array_equal(pinned.read_vertex(np.arange(nv), "rank"), ranks)
    if mutation == "compaction":
        assert serving.stats["compactions"] >= 1


def test_snapshot_isolation_pinned_reads():
    nv = 50
    edges = random_graph(nv, 80, seed=8)
    serving = _serve_cc(edges, nv, "chromatic")
    serving.recompute()
    pinned = serving.snapshot()
    before = pinned.read_vertex(np.arange(nv), "label").copy()
    assert pinned.find_edge(*edges[0]) is not None
    serving.update_vertex_data([0], {"label": np.asarray([-9], np.int32)})
    serving.add_edge(*[e for e in [(0, 33), (1, 44)]
                       if serving.find_edge(*e) is None][0])
    serving.recompute()
    assert np.array_equal(pinned.read_vertex(np.arange(nv), "label"), before)
    assert pinned.n_edges == len(edges)
    new = serving.snapshot()
    assert new.n_edges == len(edges) + 1
    assert int(new.read_vertex([0], "label")[0]) == -9


def test_publish_every_publishes_mid_recompute_cuts():
    nv = 80
    edges = zipf_edges(nv, seed=7)
    serving = _serve_cc(edges, nv, "locking", max_pending=4,
                        publish_every=2)
    seen = []
    publish = serving._publish

    def spy(**kw):
        publish(**kw)
        seen.append(serving.snapshot().superstep)
    serving._publish = spy
    r = serving.recompute()
    assert r["supersteps"] > 4
    assert seen[:2] == [2, 4] and seen[-1] == r["supersteps"]


def test_top_k_and_round_metadata():
    nv = 30
    edges = random_graph(nv, 40, seed=9)
    graph, update, syncs = pagerank.build(edges, nv, slack=4, device=CPU)
    serving = api.serve(graph, update, syncs=syncs, scheduler="chromatic",
                        slack=4, device=CPU)
    serving.recompute()
    snap = serving.snapshot()
    ids, vals = snap.top_k("rank", 5)
    ranks = snap.read_vertex(np.arange(nv), "rank")
    assert np.array_equal(np.sort(vals)[::-1], vals)
    assert vals[0] == ranks.max() and np.array_equal(ranks[ids], vals)
    assert snap.round == 1
    rg, ru, rs = ref_pagerank.build(edges, nv, slack=4)
    ref = ref_api.serve(rg, ru, syncs=rs, scheduler="chromatic", slack=4)
    ref.recompute()
    assert np.array_equal(ids, ref.snapshot().top_k("rank", 5)[0])


def test_save_snapshot_restores_in_both_packages(tmp_path):
    nv = 50
    edges = random_graph(nv, 80, seed=8)
    serving = _serve_cc(edges, nv, "chromatic")
    with pytest.raises(ValueError, match="nothing to save"):
        serving.save_snapshot(str(tmp_path / "x.npz"))
    serving.recompute()
    p = str(tmp_path / "serve.npz")
    serving.save_snapshot(p)
    ref = _ref_serve_cc(edges, nv, "chromatic")
    ref.recompute()
    eng = ref._engine()
    state = ref_ckpt.restore_engine_state(p, eng.init_state())
    assert np.array_equal(np.asarray(state.vertex_data["label"]),
                          serving.graph.vertex_data["label"].numpy())
    assert int(state.superstep) == serving.stats["supersteps"]


# ----------------------------------------------------------------------
# Facade keyword hygiene, both directions
# ----------------------------------------------------------------------

def test_serve_rejects_inapplicable_knobs_naming_allowed_set():
    nv = 20
    edges = random_graph(nv, 30, seed=0)
    graph, update, _ = cc.build(edges, nv, slack=4, device=CPU)
    rg, ru, _ = ref_cc.build(edges, nv, slack=4)
    # the allowed set is the port's (it has no kernel_interpret)
    with pytest.raises(ValueError) as got:
        api.serve(graph, update, scheduler="chromatic", k_select=4,
                  device=CPU)
    assert "allowed options" in str(got.value)
    assert "chromatic" in str(got.value)
    for kw in (dict(scheduler="sequential"), dict(slack=0),
               dict(slack=True)):
        with pytest.raises(ValueError) as got:
            api.serve(graph, update, device=CPU, **kw)
        with pytest.raises(ValueError) as want:
            ref_api.serve(rg, ru, **kw)
        assert str(got.value) == str(want.value)


def test_run_redirects_serve_only_kwargs():
    nv = 20
    edges = random_graph(nv, 30, seed=0)
    graph, update, _ = cc.build(edges, nv, device=CPU)
    rg, ru, _ = ref_cc.build(edges, nv)
    assert api.SERVE_ONLY_KWARGS == ref_api.SERVE_ONLY_KWARGS
    for kw in ({"slack": 4}, {"publish_every": 2}, {"edge_capacity": 64}):
        with pytest.raises(ValueError, match="api.serve") as got:
            api.run(graph, update, scheduler="chromatic", device=CPU, **kw)
        with pytest.raises(ValueError) as want:
            ref_api.run(rg, ru, scheduler="chromatic", **kw)
        assert str(got.value) == str(want.value)


def test_serving_engine_requires_slack_storage():
    nv = 20
    edges = random_graph(nv, 30, seed=0)
    graph, update, _ = cc.build(edges, nv, device=CPU)  # no slack
    spec = api.EngineSpec(scheduler="chromatic")
    with pytest.raises(ValueError, match="slack"):
        ServingEngine(graph, update, spec=spec)
    # api.serve stores it again with slack instead
    serving = api.serve(graph, update, scheduler="chromatic", device=CPU)
    assert serving.graph.slack == 4
    serving.recompute()
    assert np.array_equal(serving.graph.vertex_data["label"].numpy(),
                          _rebuild_labels(edges, nv, "chromatic"))


# ----------------------------------------------------------------------
# The sharded arm on a small LocalMesh
# ----------------------------------------------------------------------

@pytest.mark.distributed
@pytest.mark.parametrize("scheduler", ["chromatic", "locking"])
def test_distributed_serving_incremental_matches_rebuild(scheduler):
    nv = 64
    edges = zipf_edges(nv, alpha=2.0, max_deg=24, seed=7)
    graph, update, _ = cc.build(edges, nv, slack=4, device=CPU)
    asg = two_phase_partition(nv, edges, 4, seed=0)
    kw = {"max_pending": 8} if scheduler == "locking" else {}
    serving = api.serve(graph, update, scheduler=scheduler, n_shards=4,
                        partition=asg, slack=4, device=CPU,
                        mesh=LocalMesh(4, [CPU]), **kw)
    serving.recompute()
    new = np.asarray([e for e in [[0, 41], [5, 60], [2, 33]]
                      if serving.find_edge(*e) is None],
                     np.int64).reshape(-1, 2)
    serving.add_edges(new)
    r = serving.recompute()
    assert r["dirty"] > 0 and r["launches"] == []
    all_edges = np.vstack([edges, new])
    g2, u2, _ = cc.build(all_edges, nv, device=CPU)
    res = api.run(g2, u2, scheduler=scheduler, n_shards=4, device=CPU,
                  partition=two_phase_partition(nv, all_edges, 4, seed=0),
                  **kw)
    assert torch.equal(serving.graph.vertex_data["label"],
                       res.vertex_data["label"])
    assert np.array_equal(serving.graph.vertex_data["label"].numpy(),
                          cc.reference_components(all_edges, nv))
    with pytest.raises(ValueError, match="distributed rounds"):
        serving.save_snapshot("unused.npz")


@pytest.mark.parametrize("argv", [
    ["examples/dynamic_pagerank_torch.py", "--device", "cpu"],
    ["-m", "repro_torch.launch.graph_serve", "--device", "cpu",
     "--vertices", "300", "--batches", "3"]], ids=["example", "launcher"])
def test_serving_example_and_launcher_run_on_cpu(argv):
    import os
    import subprocess
    import sys
    from torch_dist_parity import ROOT
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert ("OK" in proc.stdout) if argv[0].startswith("examples") \
        else ("final:" in proc.stdout and "[t=2]" in proc.stdout)
