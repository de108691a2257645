"""The port's chromatic PageRank against the reference's ``api.run``.

The reference graph is carried across with ``interop.graph_from_arrays``
so both engines run on identical storage.  Ranks are held to a
tolerance, not bitwise: XLA on the CPU contracts PageRank's combine
``ALPHA + (1 - ALPHA) * y`` into a fused multiply-add, and eager torch
does not fuse, so each update can differ by an ulp.  The port's own
invariants are bitwise: the kernel arm equals the dense arm, and the
GPU run equals the CPU run (``tests/test_torch_cuda.py``, on a card).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.apps import pagerank as ref_pagerank
from repro.core import exec as ref_exec
from repro.core import sync as ref_sync
from repro.core import update as ref_update
from repro_torch import api, interop
from repro_torch.apps import coem, gibbs, pagerank
from repro_torch.core import exec as port_exec
from repro_torch.core import graph as port_graph
from repro_torch.core import sync as port_sync
from repro_torch.core import update as port_update
from repro_torch.core.coloring import single_color
from repro_torch.core.engine_chromatic import ChromaticEngine
from repro_torch.core.engine_sequential import run_sequential
from repro_torch.core.graph import zipf_edges
from repro_torch.profile.trace import tracing
from torch_parity import ENGINE_GRAPHS, reference_arrays

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def runs():
    """Per graph: the reference graph, its triple, the port's graph and
    triple on the same storage, and the reference's two runs."""
    out = {}
    for name, (n, edges_fn, eps) in ENGINE_GRAPHS.items():
        edges = edges_fn()
        g, upd, syncs = ref_pagerank.build(edges, n, eps=eps)
        port_g = interop.graph_from_arrays(*reference_arrays(g), device="cpu")
        port_triple = (port_g, pagerank.make_update(eps),
                       (pagerank.second_most_popular_sync(),
                        pagerank.total_rank_sync()))
        fixed = ref_api.run(g, upd, syncs=syncs, num_supersteps=5)
        conv = ref_api.run(g, upd, syncs=syncs)
        out[name] = dict(n=n, edges=edges, eps=eps, port=port_triple,
                         fixed=fixed, conv=conv)
    return out


def _port_run(case, **kw):
    g, upd, syncs = case["port"]
    return api.run(g, upd, syncs=syncs, device="cpu", **kw)


def _ranks(res):
    return np.asarray(res.vertex_data["rank"])


@pytest.mark.parametrize("name", sorted(ENGINE_GRAPHS))
def test_fixed_supersteps_match_reference(runs, name):
    case = runs[name]
    got = _port_run(case, num_supersteps=5)
    want = case["fixed"]
    assert got.superstep == want.superstep == 5
    assert got.n_updates == want.n_updates
    np.testing.assert_allclose(_ranks(got), _ranks(want), rtol=1e-5)


# (superstep, n_updates) of the port's converged run where an eps
# decision flipped against the reference's (ROADMAP queue C): the ulp
# from the unfused combine moves one |delta| across eps, and the extra
# neighbour wakes add updates.  The reference's counts are asserted too.
EPS_FLIPS = {"quickstart": ((25, 4791), (25, 4787))}


@pytest.mark.parametrize("name", sorted(ENGINE_GRAPHS))
def test_converged_run_matches_reference(runs, name):
    case = runs[name]
    got = _port_run(case)
    want = case["conv"]
    assert not got.active_any and not want.active_any
    counts = ((got.superstep, got.n_updates),
              (want.superstep, want.n_updates))
    if name in EPS_FLIPS:
        assert counts == EPS_FLIPS[name]
    else:
        assert counts[0] == counts[1]
    np.testing.assert_allclose(_ranks(got), _ranks(want), rtol=0,
                               atol=10 * case["eps"])
    assert float(got.globals["total_rank"]) == pytest.approx(
        float(want.globals["total_rank"]), rel=1e-5)
    ranks = _ranks(got)
    assert float(got.globals["top2"][0]) == np.sort(ranks)[-2]
    assert float(got.globals["total_rank"]) == pytest.approx(
        ranks.astype(np.float64).sum(), rel=1e-5)


def _fma_combine_update(eps):
    """PageRank whose combine rounds ``ALPHA + (1 - ALPHA) * y`` once,
    as the fused multiply-add XLA emits on the CPU (emulated in float64,
    where the product of two float32 values is exact)."""
    a = float(np.float32(pagerank.ALPHA))
    b = float(np.float32(1.0 - pagerank.ALPHA))

    def combine(scope, y):
        new_rank = (a + b * y[..., 0].double()).float()
        delta = torch.abs(new_rank - scope.v_data["rank"])
        return port_update.UpdateResult(
            v_data={"rank": new_rank},
            resched_nbrs=(delta > eps)[:, None].expand(scope.nbr_mask.shape),
            priority=delta)

    agg = pagerank.make_update(eps).aggregator
    return port_update.aggregator_update(agg.feature, agg.weight, combine)


@pytest.mark.parametrize("name", sorted(ENGINE_GRAPHS))
def test_bitwise_with_reference_once_the_combine_is_fused(runs, name):
    """Everything but the combine's rounding is bitwise the reference's:
    with the combine fused as XLA fuses it, ranks, counts and syncs of
    the converged run equal the reference's exactly."""
    case = runs[name]
    g, _, syncs = case["port"]
    got = api.run(g, _fma_combine_update(case["eps"]), syncs=syncs,
                  device="cpu")
    want = case["conv"]
    np.testing.assert_array_equal(_ranks(got), _ranks(want))
    assert (got.superstep, got.n_updates) == (want.superstep, want.n_updates)
    assert got.globals["total_rank"].item() == np.float32(
        want.globals["total_rank"])


@pytest.mark.parametrize("name", sorted(ENGINE_GRAPHS))
def test_converged_ranks_are_a_fixed_point(runs, name):
    case = runs[name]
    r = _ranks(_port_run(case)).astype(np.float64)
    wr = pagerank.sparse_matvec(case["edges"], case["n"], r)
    resid = np.abs(r - (pagerank.ALPHA + (1 - pagerank.ALPHA) * wr)).max()
    assert resid < 100 * case["eps"]
    oracle = pagerank.reference_pagerank(case["edges"], case["n"])
    np.testing.assert_allclose(r, oracle, atol=100 * case["eps"])


@pytest.mark.parametrize("name", sorted(ENGINE_GRAPHS))
def test_kernel_arm_equals_dense_arm_bitwise(runs, name):
    case = runs[name]
    kern = _port_run(case, use_kernel=True)
    dense = _port_run(case, use_kernel=False)
    assert torch.equal(kern.vertex_data["rank"], dense.vertex_data["rank"])
    assert (kern.superstep, kern.n_updates) == (dense.superstep,
                                                dense.n_updates)
    for k in kern.globals:
        for a, b in zip(kern.globals[k] if isinstance(kern.globals[k], tuple)
                        else [kern.globals[k]],
                        dense.globals[k] if isinstance(dense.globals[k], tuple)
                        else [dense.globals[k]]):
            assert torch.equal(a, b)


def test_pagerank_build_runs_end_to_end():
    n, edges_fn, eps = ENGINE_GRAPHS["quickstart"]
    g, upd, syncs = pagerank.build(edges_fn(), n, eps=eps, device="cpu")
    res = api.run(g, upd, syncs=syncs, max_supersteps=3, device="cpu")
    assert res.superstep == 3 and res.n_updates > 0
    assert res.vertex_data["rank"].shape == (n,)


def test_sum_and_top_two_syncs_match_reference():
    rng = np.random.default_rng(7)
    for n in (1, 6, 37):
        rank = rng.normal(size=n).astype(np.float32)
        rank[rng.integers(0, n, n // 3)] = 0.5          # ties
        ids = np.arange(n, dtype=np.int32)
        vd_j = {"rank": jnp.asarray(rank), "id": jnp.asarray(ids)}
        vd_t = {"rank": torch.from_numpy(rank), "id": torch.from_numpy(ids)}
        want = ref_sync.sum_sync("s", lambda r: r["rank"]).run(vd_j)
        got = port_sync.sum_sync("s", lambda r: r["rank"]).run(vd_t)
        assert got.item() == np.float32(want)
        mk = lambda mod: mod.top_two_sync("t", lambda r: r["rank"],
                                          id_fn=lambda r: r["id"])
        (wv, wi), (gv, gi) = mk(ref_sync).run(vd_j), mk(port_sync).run(vd_t)
        assert gv.item() == np.float32(wv) and gi.item() == int(wi)


def _scope_inputs(n=40, b=12, d=5, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.choice(n, size=b, replace=False).astype(np.int32)
    sel = rng.random(b) < 0.7
    nbrs = rng.integers(0, n, (b, d)).astype(np.int32)
    mask = rng.random((b, d)) < 0.6
    return rng, ids, sel, nbrs, mask


def test_consume_and_reschedule_matches_reference():
    rng, ids, sel, nbrs, mask = _scope_inputs()
    n = 40
    active = rng.random(n) < 0.5
    prio = rng.random(n).astype(np.float32)
    resched = rng.random(mask.shape) < 0.5
    self_r = rng.random(len(ids)) < 0.5
    pr = rng.random(len(ids)).astype(np.float32)

    def both(mod, res_cls, to, **kw):
        res = res_cls(v_data={}, resched_self=to(self_r),
                      resched_nbrs=to(resched), priority=to(pr))
        a, p = mod.consume_and_reschedule(
            to(active), to(prio), to(ids), to(sel), to(nbrs), to(mask),
            res, **kw)
        return np.asarray(a), np.asarray(p)

    want = both(ref_exec, ref_update.UpdateResult, jnp.asarray, sentinel=n)
    got = both(port_exec, port_update.UpdateResult, torch.from_numpy)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_gather_and_scatter_match_reference():
    _, edges_fn, _ = ENGINE_GRAPHS["quickstart"]
    edges = edges_fn()
    n = 200
    ref_g = ref_pagerank.make_graph(edges, n)
    g = interop.graph_from_arrays(*reference_arrays(ref_g), device="cpu")
    rng, ids, sel, _, _ = _scope_inputs(n=n)
    vdata = {"x": rng.normal(size=(n, 2)).astype(np.float32)}
    edata = {"e": rng.normal(size=(len(edges) + 1,)).astype(np.float32)}
    d = g.max_deg
    new_v = rng.normal(size=(len(ids), 2)).astype(np.float32)
    new_e = rng.normal(size=(len(ids), d)).astype(np.float32)

    def both(mod, struct, to):
        vd = {k: to(v) for k, v in vdata.items()}
        ed = {k: to(v) for k, v in edata.items()}
        scope = mod.gather_scopes(struct, vd, ed, to(ids), {})
        res = mod.UpdateResult(v_data={"x": to(new_v)},
                               edge_data={"e": to(new_e)},
                               nbr_data={"x": scope.nbr_data["x"] * 2})
        v2, e2 = mod.scatter_result(struct, vd, ed, to(ids), to(sel),
                                    scope, res)
        return scope, v2, e2

    ws, wv, we = both(ref_update, ref_g, jnp.asarray)
    gs, gv, ge = both(port_update, g, torch.from_numpy)
    for f in ("nbr_ids", "nbr_mask", "e_ids", "is_src", "degree"):
        np.testing.assert_array_equal(getattr(gs, f).numpy(),
                                      np.asarray(getattr(ws, f)))
    np.testing.assert_array_equal(gs.nbr_data["x"].numpy(),
                                  np.asarray(ws.nbr_data["x"]))
    np.testing.assert_array_equal(gv["x"].numpy(), np.asarray(wv["x"]))
    # the pad edge row takes masked-off writes in both; compare real rows
    np.testing.assert_array_equal(ge["e"][:-1].numpy(),
                                  np.asarray(we["e"])[:-1])


def test_route_and_dense_fold_match_reference():
    n, edges_fn, _ = ENGINE_GRAPHS["quickstart"]
    ref_g = ref_pagerank.make_graph(edges_fn(), n)
    g = interop.graph_from_arrays(*reference_arrays(ref_g), device="cpu")
    rng = np.random.default_rng(5)
    ids = rng.choice(n, size=60, replace=False).astype(np.int32)
    sel = rng.random(60) < 0.8
    w = rng.random((60, g.max_deg)).astype(np.float32)
    vals = rng.normal(size=(60, g.max_deg, 1)).astype(np.float32)
    want_w, want_v = ref_exec.route_batch_to_buckets(
        ref_g.ell, jnp.asarray(ids), jnp.asarray(sel), jnp.asarray(w),
        jnp.asarray(vals))
    got_w, got_v = port_exec.route_batch_to_buckets(
        g.ell, torch.from_numpy(ids), torch.from_numpy(sel),
        torch.from_numpy(w), torch.from_numpy(vals))
    for a, b in zip(got_w + got_v, list(want_w) + list(want_v)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = ref_exec.bucketed_dense_fold(
        ref_g.ell, jnp.asarray(ids), jnp.asarray(sel), jnp.asarray(w),
        jnp.asarray(vals), interpret=True)
    got = port_exec.bucketed_dense_fold(
        g.ell, torch.from_numpy(ids), torch.from_numpy(sel),
        torch.from_numpy(w), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _grid_edges(nz, ny, nx):
    """The 6-neighbour grid's edges."""
    idx = np.arange(nz * ny * nx).reshape(nz, ny, nx)
    return np.concatenate([
        np.stack([idx[:, :, :-1].ravel(), idx[:, :, 1:].ravel()], 1),
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
        np.stack([idx[:-1].ravel(), idx[1:].ravel()], 1)])


@pytest.fixture(scope="module")
def plan_apps():
    """Per app: a tiny graph, its update and syncs: hubs for the two
    aggregators; an Ising grid for Gibbs, a dense update whose few
    border rows join the interior's group of their color."""
    n = 300
    edges = zipf_edges(n, alpha=2.0, seed=3)
    prob = coem.synthetic_ner(120, 80, 3, mean_deg=8, seed_frac=0.15,
                              seed=1, device="cpu")
    shape = (4, 60, 80)
    ising = gibbs.ising_problem(_grid_edges(*shape), int(np.prod(shape)),
                                0.4, field=0.1, seed=2, device="cpu")
    return {"pagerank": pagerank.build(edges, n, eps=1e-4, device="cpu"),
            "coem": coem.build(prob, eps=1e-4),
            "gibbs": gibbs.build(ising)}


def _routed_run(graph, update, syncs, use_kernel, max_supersteps):
    """The gather-and-route path driven by hand: the color batches
    padded to ``[Cmax]`` (``build_color_batches``) through
    ``apply_batch`` at the bucket dispatch, with no phase plan."""
    ids, valid = (torch.from_numpy(a) for a in
                  port_exec.build_color_batches(graph.colors.numpy()))
    st = port_exec.init_engine_state(graph.vertex_data, graph.edge_data,
                                     graph.n_vertices, syncs, "cpu")
    while st.superstep < max_supersteps and bool(st.active.any()):
        carry = (st.vertex_data, st.edge_data, st.active, st.priority,
                 st.n_updates)
        for c in range(ids.shape[0]):
            carry = port_exec.apply_batch(graph, update, carry, ids[c],
                                          valid[c], st.globals,
                                          use_kernel=use_kernel)
        vd, ed, act, pri, n_upd = carry
        st = port_exec.EngineState(
            vd, ed, act, pri,
            port_exec.refresh_syncs(syncs, st.globals, vd, st.superstep),
            st.superstep + 1, n_upd)
    return st


def _flat_globals(g):
    return [torch.as_tensor(v) for k in sorted(g)
            for v in (g[k] if isinstance(g[k], tuple) else (g[k],))]


@pytest.mark.parametrize("scheduler", ["chromatic", "bsp"])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("app", ["coem", "pagerank", "gibbs"])
def test_color_plan_equals_the_routed_path_bitwise(plan_apps, app,
                                                   use_kernel, scheduler):
    """A phase run on the color-major plan, each group at its stored
    width or a joined group's, equals the padded, routed phase bit for
    bit: data, counts, supersteps, syncs and the task set (BSP: one
    color whose rows are adjacent, so groups reschedule each other's
    rows)."""
    graph, update, syncs = plan_apps[app]
    if scheduler == "bsp":
        graph = graph.with_colors(single_color(graph.n_vertices))
    steps = 8 if app == "gibbs" else 40          # Gibbs sweeps forever
    got = api.run(graph, update, syncs=syncs, scheduler=scheduler,
                  use_kernel=use_kernel, max_supersteps=steps, device="cpu")
    assert got.engine.plan is not None
    want = _routed_run(graph, update, syncs, use_kernel, steps)
    for k in want.vertex_data:
        assert torch.equal(got.vertex_data[k], want.vertex_data[k]), k
    assert (got.superstep, got.n_updates) == (want.superstep,
                                              int(want.n_updates))
    assert torch.equal(got.state.active, want.active)
    assert torch.equal(got.state.priority, want.priority)
    for a, b in zip(_flat_globals(got.globals), _flat_globals(want.globals),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("app", ["pagerank", "gibbs"])
def test_color_plan_holds_each_row_at_its_stored_width(plan_apps, app):
    """Phase ``c`` of the plan is color ``c``'s rows, in groups of one
    width, each row's slots those of the graph's storage: the widest
    row's stored width, the others padded to it by at most
    ``JOIN_PAD_SHARE`` of the group's slots (the grid's border rows
    join the interior's group; the Zipf graph's groups stay apart)."""
    graph, update, _ = plan_apps[app]
    eng = ChromaticEngine(graph, update)
    ell, colors = graph.ell, graph.colors
    width = dict(zip(range(ell.n_buckets), ell.widths))
    stored = {}
    for b in range(ell.n_buckets):
        for r in ell.perm[ell.starts[b]: ell.starts[b + 1]].tolist():
            stored[r] = width[b]
    seen, joined = [], 0
    for c, (ids, valid, blocks) in enumerate(eng.plan.phases):
        assert bool(valid.all()) and bool((colors[ids.long()] == c).all())
        assert list(blocks.offsets) == sorted(blocks.offsets)
        assert blocks.offsets[-1] == ids.shape[0]
        widths = [rows.nbrs.shape[1] for rows in blocks.rows]
        assert widths == sorted(set(widths))
        for g, rows in enumerate(blocks.rows):
            gid = ids[blocks.offsets[g]: blocks.offsets[g + 1]]
            w = rows.nbrs.shape[1]
            own = [stored[r] for r in gid.tolist()]
            assert max(own) == w
            assert (sum(w - x for x in own)
                    <= port_graph.JOIN_PAD_SHARE * len(own) * w)
            joined += len(set(own)) > 1
            for a, b in zip(rows, ell.rows(gid, width=w)):
                assert torch.equal(a, b)
        seen += ids.tolist()
    assert sorted(seen) == list(range(graph.n_vertices))
    assert eng.plan.store.padded_slots < ell.padded_slots * eng.n_phases
    assert (joined == eng.n_phases) if app == "gibbs" else joined == 0


def test_step_on_a_mutated_structure_lays_the_plan_out_again():
    """``step_on`` against an inserted-into structure (the serving path)
    lays the plan out again from that structure and runs on it, bitwise
    the routed path over the same structure, with no fallback phase."""
    n = 300
    edges = zipf_edges(n, alpha=2.0, seed=3)
    graph, update, syncs = pagerank.build(edges, n, eps=1e-4, slack=2,
                                          device="cpu")
    colors = graph.colors.numpy()
    rng = np.random.default_rng(0)
    have = {tuple(sorted(e)) for e in edges.tolist()}
    new = [(u, v) for u, v in rng.integers(0, n, (200, 2)).tolist()
           if colors[u] != colors[v] and (min(u, v), max(u, v)) not in have]
    mutated = port_graph.insert_edges(graph, np.asarray(new[:20]))
    assert mutated is not None
    eng = ChromaticEngine(graph, update, syncs)
    built = eng.plan
    with tracing("cpu") as rec:
        got = eng.step_on(mutated, eng.init_state())
    assert eng.plan is not built and eng.plan.source is mutated.ell
    assert rec.summary()["counters"].get("phases.fallback", 0) == 0
    struct = dataclasses.replace(graph, ell=mutated.ell,
                                 degree=mutated.degree)
    want = _routed_run(struct, update, syncs, True, 1)
    for k in want.vertex_data:
        assert torch.equal(got.vertex_data[k], want.vertex_data[k]), k
    assert int(got.n_updates) == int(want.n_updates)
    assert torch.equal(got.active, want.active)
    assert torch.equal(got.priority, want.priority)


def test_unported_options_raise(monkeypatch):
    """The sequential oracle and ``trace=`` are ported (ROADMAP A7):
    they run, and so do the distributed engines (A9).  Fault tolerance
    (A10) and online serving (A11) are ported too: half of a
    checkpoint pair and a serving-only option raise the reference's
    messages; an inapplicable option (``exchange_edges`` on one device)
    raises the reference's message; no GPU and no device raises."""
    n, edges_fn, eps = ENGINE_GRAPHS["quickstart"]
    g, upd, syncs = pagerank.build(edges_fn(), n, eps=eps, device="cpu")
    res = api.run(g, upd, syncs=syncs, scheduler="sequential",
                  max_supersteps=2, device="cpu")
    vd, _, _, n_upd = run_sequential(g, upd, syncs=syncs, max_supersteps=2)
    assert res.superstep is None and res.n_updates == n_upd
    assert torch.equal(res.vertex_data["rank"], vd["rank"])
    traced = api.run(g, upd, syncs=syncs, trace=True, num_supersteps=3,
                     device="cpu")
    assert [r["superstep"] for r in traced.trace] == [1, 2, 3]
    plain = api.run(g, upd, syncs=syncs, device="cpu")
    for kwargs in (dict(n_shards=2), dict(partition=np.zeros(n, np.int64))):
        dist = api.run(g, upd, syncs=syncs, device="cpu", **kwargs)
        assert torch.equal(dist.vertex_data["rank"], plain.vertex_data["rank"])
        assert (dist.superstep, dist.n_updates) == (plain.superstep,
                                                    plain.n_updates)
    for kwargs, item in ((dict(exchange_edges=True), "does not accept"),
                         (dict(checkpoint_every=2), "go together"),
                         (dict(slack=2), "api.serve")):
        with pytest.raises(ValueError, match=item):
            api.run(g, upd, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="does not accept"):
        api.run(g, upd, k_select=8, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.run(g, upd)


def test_quickstart_example_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "converged in" in proc.stdout
