"""Netflix-scale ALS's pieces on the CPU, at small sizes.

* The port's ALS against the benchmark's plain reference
  (``bench/reference/als.py``, loaded by its path: one reference), on
  Netflix-shaped triples from the benchmark's generator
  (``bench/gen/netflix.py``) at 400 users x 60 movies, d = 20, 3 sweeps.
  Tolerances: the port solves in float32 what the reference solves in
  float64.  A factor's normwise gap is its systems' rounding, ~2^-24
  times their condition (the ridge lam * n keeps it below ~1e3): the
  worst measured over six seeds is 4.4e-6, so 1e-4 leaves 20x room,
  and the bfloat16 control (factors and ratings rounded to 2^-8) misses
  it by 70x and more (7.5e-3 and up).  The sync RMSE is a float32 sum of
  squared residuals, at most 3.2e-8 from the float64 RMSE of the same
  factors, and that RMSE at most 9.5e-8 from the reference's: 4e-6 for
  both, which the control misses (4.7e-5 and up; 6.4e-5 and up).
* ``synthetic_netflix`` is ``from_ratings`` over its own triples,
  bitwise.
* On a heavy-tailed bipartite graph (rows of 1 to 512 slots) the
  color-major plan equals the padded, routed phases: bitwise in the
  factors, the task set and the counts; the residuals to a float32 sum's
  rounding.
* The ALS update's spans and counter inside ``tracing()``, and none of
  their work outside it.
* The build's sorts on the graph's device equal numpy's, bitwise.
* The generator's degree laws at the published sizes, and its pairing's
  realised user degrees against the law.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.apps import als
from repro_torch.core import exec as port_exec
from repro_torch.core import graph as port_graph
from repro_torch.profile import trace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from bench.gen import netflix as gen  # noqa: E402


def _by_path(rel):
    spec = importlib.util.spec_from_file_location(
        "als_reference_under_test", ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _by_path("bench/reference/als.py")
CONFIG = json.loads((ROOT / "bench/configs/als-netflix.json").read_text())
CPU = torch.device("cpu")
LAM = 0.01
# Netflix-shaped at 400 x 60: the published medians and maxima's shape,
# each side's maximum within the other side's count
TINY = dict(n_users=400, n_movies=60, n_ratings=4000, d=20, noise=0.1,
            user_degrees={"minimum": 1, "median": 6, "maximum": 55},
            movie_degrees={"minimum": 3, "median": 40, "maximum": 380})
# rows from 1 to 512 slots
HEAVY = dict(n_users=600, n_movies=50, n_ratings=6000, d=20, noise=0.1,
             user_degrees={"minimum": 1, "median": 7, "maximum": 45},
             movie_degrees={"minimum": 1, "median": 60, "maximum": 512})
FACTOR_TOL = 1e-4
RMSE_TOL = 4e-6


def _problem(cfg, seed):
    t = gen.netflix(torch, cfg, seed, CPU)
    pairs = np.stack([t["users"].numpy(), t["movies"].numpy()], axis=1)
    return t, als.from_ratings(cfg["n_users"], cfg["n_movies"], pairs,
                               t["ratings"].numpy(), cfg["d"],
                               t["w0"].numpy(), device="cpu")


def _triples(cfg, t):
    return ref.Triples(cfg["n_users"], cfg["n_movies"], t["users"].numpy(),
                       t["movies"].numpy(), t["ratings"].numpy(), CPU)


def _gaps(triples, best, w, sync):
    best_rmse = ref.rmse(triples, best)
    return ref.compare(triples, best, best_rmse, w, sync, 0)


@pytest.mark.parametrize("seed", [1, 2 ** 33 + 5])
def test_port_matches_the_float64_reference(seed):
    t, prob = _problem(TINY, seed)
    g, upd, syncs = als.build(prob, lam=LAM, eps=0.0)
    res = api.run(g, upd, syncs=syncs, scheduler="chromatic",
                  max_supersteps=3, device="cpu")
    assert res.superstep == 3 and res.n_updates == 3 * g.n_vertices
    triples = _triples(TINY, t)
    best = ref.sweeps(triples, t["w0"].numpy(), LAM, 3)
    got = _gaps(triples, best, res.vertex_data["w"].numpy(),
                float(res.globals["rmse"]))
    assert got["factor_gap_max"] < FACTOR_TOL, got
    assert got["rmse_gap"] < RMSE_TOL and got["rmse_ref_gap"] < RMSE_TOL, got


@pytest.mark.parametrize("seed", [1, 2 ** 33 + 5])
def test_the_tolerances_fail_the_bfloat16_control(seed):
    t, _ = _problem(TINY, seed)
    triples = _triples(TINY, t)
    best = ref.sweeps(triples, t["w0"].numpy(), LAM, 3)
    low = ref.sweeps(triples, t["w0"].numpy(), LAM, 3, lowp=True)
    got = _gaps(triples, best, low.numpy(), ref.rmse(triples, low, lowp=True))
    assert got["factor_gap_max"] > 10 * FACTOR_TOL, got
    assert got["rmse_gap"] > RMSE_TOL, got
    assert got["rmse_ref_gap"] > 10 * RMSE_TOL, got


def test_synthetic_netflix_is_from_ratings_bitwise():
    a = als.synthetic_netflix(300, 40, d=20, density=0.1, seed=3,
                              device="cpu")
    w0 = np.random.default_rng(3)
    b = als.from_ratings(300, 40, a.pairs, a.ratings, 20,
                         a.graph.vertex_data["w"].numpy(), device="cpu")
    assert a.noise == 0.1 and b.noise == 0.0
    ga, gb = a.graph, b.graph
    for x, y in zip(ga.ell.slots, gb.ell.slots, strict=True):
        assert torch.equal(x, y)
    assert (ga.ell.widths, ga.ell.starts) == (gb.ell.widths, gb.ell.starts)
    assert torch.equal(ga.ell.perm, gb.ell.perm)
    assert torch.equal(ga.degree, gb.degree)
    assert torch.equal(ga.colors, gb.colors)
    assert np.array_equal(ga.edges_np, gb.edges_np)
    for k in ga.vertex_data:
        assert torch.equal(ga.vertex_data[k], gb.vertex_data[k]), k
    assert torch.equal(ga.edge_data["rating"], gb.edge_data["rating"])
    # w0 is the draw after the ratings' noise from the same stream
    w0.normal(size=(300, 20))
    w0.normal(size=(40, 20))
    w0.random((300, 40))
    w0.normal(size=len(a.ratings))
    want = w0.normal(size=(340, 20)).astype(np.float32) * 0.1
    assert np.array_equal(ga.vertex_data["w"].numpy(), want)


def _routed_run(graph, update, syncs, max_supersteps):
    """The padded color batches through ``apply_batch`` with no plan."""
    ids, valid = (torch.from_numpy(a) for a in
                  port_exec.build_color_batches(graph.colors.numpy()))
    st = port_exec.init_engine_state(graph.vertex_data, graph.edge_data,
                                     graph.n_vertices, syncs, "cpu")
    while st.superstep < max_supersteps and bool(st.active.any()):
        carry = (st.vertex_data, st.edge_data, st.active, st.priority,
                 st.n_updates)
        for c in range(ids.shape[0]):
            carry = port_exec.apply_batch(graph, update, carry, ids[c],
                                          valid[c], st.globals)
        vd, ed, act, pri, n_upd = carry
        st = port_exec.EngineState(
            vd, ed, act, pri,
            port_exec.refresh_syncs(syncs, st.globals, vd, st.superstep),
            st.superstep + 1, n_upd)
    return st


@pytest.mark.parametrize("eps", [0.0, 0.05])
def test_color_plan_equals_the_routed_path_bitwise(eps):
    _, prob = _problem(HEAVY, 5)
    g, upd, syncs = als.build(prob, lam=LAM, eps=eps)
    deg = g.degree.numpy()
    assert deg.min() == 1 and deg.max() == 512
    got = api.run(g, upd, syncs=syncs, scheduler="chromatic",
                  max_supersteps=3, device="cpu")
    assert got.engine.plan is not None
    assert sum(len(p[2].rows) for p in got.engine.plan.phases) > 2
    want = _routed_run(g, upd, syncs, 3)
    for k in ("w", "cnt", "is_movie"):
        assert torch.equal(got.vertex_data[k], want.vertex_data[k]), k
    assert (got.superstep, got.n_updates) == (want.superstep,
                                              int(want.n_updates))
    assert torch.equal(got.state.active, want.active)
    assert torch.equal(got.state.priority, want.priority)
    # a row's squared residuals are summed in float32 over its scope's
    # width, which the plan and the routed path pad differently: at most
    # 512 adds of 2^-24 each, 3.1e-5 relative (3.0e-5 measured); the RMSE
    # is the root of their mean, so at most half that
    torch.testing.assert_close(got.vertex_data["err"], want.vertex_data["err"],
                               rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got.globals["rmse"], want.globals["rmse"],
                               rtol=5e-5, atol=0.0)


def test_the_update_traces_its_fold_and_solve():
    _, prob = _problem(TINY, 7)
    g, upd, syncs = als.build(prob, lam=LAM, eps=0.0)
    with trace.tracing(CPU) as rec:
        res = api.run(g, upd, syncs=syncs, scheduler="chromatic",
                      max_supersteps=2, device="cpu")
    spans = [r for r in rec.records if r.get("kind") == "span"]
    groups = sum(len(p[2].rows) for p in res.engine.plan.phases)
    solves = [r for r in spans if r["name"] == "solve"]
    folds = [r for r in spans if r["name"] == "kernel"
             and r.get("kernel") == "als_normal_eq"]
    assert len(solves) == len(folds) == 2 * groups
    by_id = {r["id"]: r for r in spans}
    assert all(by_id[r["parent"]]["name"] == "update" for r in solves + folds)
    counters = rec.summary()["counters"]
    # a dense update folds every slot it gathered
    assert counters["als.fold_slots"] == counters["slots.gathered"] > 0


def test_no_span_or_count_outside_tracing(monkeypatch):
    _, prob = _problem(TINY, 7)
    g, upd, syncs = als.build(prob, lam=LAM, eps=0.0)
    made, added = [], []
    monkeypatch.setattr(trace._Span, "__init__",
                        lambda self, *a: made.append(a))
    monkeypatch.setattr(trace._Tracer, "add",
                        lambda self, *a: added.append(a))
    api.run(g, upd, syncs=syncs, scheduler="chromatic", max_supersteps=1,
            device="cpu")
    assert trace._OPEN is None and made == [] and added == []
    assert trace.span("solve") is trace._NO_SPAN


@pytest.mark.parametrize("n,ties", [(1000, 7), (4097, 1000), (50_000, 3)])
def test_stable_argsort_is_numpys(n, ties):
    a = np.random.default_rng(n).integers(0, ties, n)
    assert np.array_equal(port_graph.stable_argsort(a, CPU),
                          np.argsort(a, kind="stable"))


# the stores a build makes: unsplit, hub-split rows, rows with free slots
STORES = {"plain": {}, "hub_split": {"w_cap": 16}, "slack": {"slack": 3}}


@pytest.mark.parametrize("store", sorted(STORES))
def test_bucket_major_edge_order_is_numpys(store):
    rng = np.random.default_rng(4)
    edges = np.concatenate([rng.integers(0, 300, (2000, 2)),
                            np.stack([np.zeros(90, np.int64),
                                      np.arange(1, 91)], axis=1)])
    g = port_graph.DataGraph.from_edges(300, edges, {}, edge_locality=False,
                                        device="cpu", **STORES[store])
    ell = g.ell
    assert (ell.starts[-1] > ell.n_rows) == (store == "hub_split")
    visits = np.concatenate([
        ell.edge_ids[b].numpy()[ell.nbr_mask[b].numpy()]
        for b in range(ell.n_buckets)]).astype(np.int64)
    _, first = np.unique(visits, return_index=True)
    assert np.array_equal(port_graph.bucket_major_edge_order(ell, len(edges)),
                          visits[np.sort(first)])


@pytest.mark.parametrize("side", ["user_degrees", "movie_degrees"])
def test_degree_laws_at_the_published_sizes(side):
    count = {"user_degrees": "n_users", "movie_degrees": "n_movies"}[side]
    law, published = CONFIG[side], CONFIG["published"][side]
    n, total = CONFIG[count], CONFIG["n_ratings"]
    d = gen.degree_law(torch, n, law["minimum"], law["median"],
                       law["maximum"], total, CPU)
    assert d.shape == (n,) and bool((d[1:] >= d[:-1]).all())
    assert int(d.sum()) == total == CONFIG["published"]["n_ratings"]
    assert abs(float(d.double().mean()) - published["mean"]) < 0.01
    assert float(d.double().median()) == published["median"]
    assert int(d[-1]) == published["maximum"] and int(d[-2]) < 0.9 * int(
        d[-1])
    assert int(d[0]) == law["minimum"]
    placed = gen.placed(torch, d, 0, CPU)
    assert torch.equal(placed.sort().values, d) and not torch.equal(placed, d)


# Netflix-shaped at 6,000 x 1,000: the heaviest user's target is 99.3 %
# of the movies, as Netflix's 17,653 of 17,770
SATURATED = dict(n_users=6000, n_movies=1000, n_ratings=600_000, d=20,
                 noise=0.1,
                 user_degrees={"minimum": 1, "median": 50, "maximum": 993},
                 movie_degrees={"minimum": 3, "median": 200,
                                "maximum": 5900})


def _realised(cfg, seed, device):
    users, movies = gen.pairs(torch, cfg, seed, device)
    target, k = gen.degrees(torch, cfg, device)
    return (users, movies, torch.bincount(users, minlength=cfg["n_users"]),
            target, k)


def _assert_the_law_is_met(cfg, users, movies, deg, k, median_tol, max_tol):
    n_users, n_movies = cfg["n_users"], cfg["n_movies"]
    law = cfg["user_degrees"]
    assert users.shape == (cfg["n_ratings"],)
    assert torch.equal(torch.bincount(movies, minlength=n_movies), k)
    key = users * n_movies + movies
    assert torch.unique(key).numel() == key.numel()
    assert int(deg.min()) >= 1
    median = float(deg.double().median())
    assert abs(median - law["median"]) <= median_tol * law["median"], median
    top = torch.sort(deg, descending=True).values[:2].tolist()
    assert abs(top[0] - law["maximum"]) <= max_tol * law["maximum"], top
    assert top[1] < 0.95 * top[0], top


@pytest.mark.parametrize("seed", [1, 2, 2 ** 33 + 5])
def test_the_pairing_meets_the_users_law(seed):
    """Each user's realised degree is a sum of its draws, one a movie, so
    it meets its target in expectation (``race_weights``), not exactly:
    the median within 5 % and the maximum within 2 % (at this size a
    heavy user's count spreads by ~3 draws, and the small movies' races
    stray from Rosen's chances; measured: median 50-51, max 986-996
    against 50 and 993).  Weights in proportion to the targets saturate
    the heavy users: median 72, max ~440."""
    users, movies, deg, target, k = _realised(SATURATED, seed, CPU)
    _assert_the_law_is_met(SATURATED, users, movies, deg, k, 0.05, 0.02)
    assert int(target.max()) == SATURATED["user_degrees"]["maximum"]


def test_race_weights_meet_the_targets_in_expectation():
    """The fit's own equations, solved: each movie degree's expected
    draws are its degree and each user degree's expected count is its
    target, to float32's rounding of the weights."""
    target, k = gen.degrees(torch, SATURATED, CPU)
    w = gen.race_weights(torch, target, k).double()
    a, first = np.unique(target.numpy(), return_index=True)
    wa = w[torch.from_numpy(first)]
    c = torch.from_numpy(np.bincount(np.unique(target.numpy(),
                                               return_inverse=True)[1]))
    kk, e = torch.unique(k, return_counts=True)

    # each movie degree's threshold, by bisection on its expected draws
    lo = torch.zeros(len(kk), dtype=torch.float64)
    hi = torch.full_like(lo, 1e12)
    for _ in range(200):
        mid = (lo + hi) / 2
        short = (c * -torch.expm1(-mid[:, None] * wa[None, :])).sum(1) < kk
        lo, hi = torch.where(short, mid, lo), torch.where(short, hi, mid)
    t = lo
    expected = (e.double()[:, None] * -torch.expm1(
        -t[:, None] * wa[None, :])).sum(0)
    rel = (expected - torch.from_numpy(a).double()).abs() / torch.from_numpy(
        a).double()
    assert float(rel.max()) < 1e-5, float(rel.max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the published size's draw "
                    "(8.5e9 race keys) is made on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_pairing_meets_the_users_law_at_the_published_size(cuda):
    """At 480,189 x 17,770 a heavy user's count spreads by a few draws in
    ~17 k: the median within 3 % of 96 and the maximum within 0.5 % of
    17,653 (measured on the CPU, one seed: 97 and 17,654)."""
    users, movies, deg, _, k = _realised(CONFIG, 2 ** 31 + 7, cuda)
    _assert_the_law_is_met(CONFIG, users, movies, deg, k, 0.03, 0.005)


def test_a_store_past_int32_offsets_is_refused():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        port_graph.SlicedEll(widths=(2 ** 15,), starts=(0, 2 ** 16),
                             n_rows=2 ** 16, max_deg=2 ** 15, pad_edge=0,
                             slots=port_graph.EllRows(z, z.bool(), z,
                                                      z.bool()),
                             perm=z, inv_perm=z)


def test_the_published_size_stays_inside_int32():
    """At the published laws (the users' targets), the stored slots of
    the power-of-two ladder and each (color, width) group's scope of
    ``rows x width x d`` factor values stay well inside int32."""
    widths = np.asarray(port_graph.default_bucket_widths(
        CONFIG["movie_degrees"]["maximum"]))
    stored, scope = 0, 0
    for side, count in (("user_degrees", "n_users"),
                        ("movie_degrees", "n_movies")):
        law = CONFIG[side]
        d = gen.degree_law(torch, CONFIG[count], law["minimum"],
                           law["median"], law["maximum"],
                           CONFIG["n_ratings"], CPU).numpy()
        w = widths[port_graph.bucket_index(widths, d)]
        stored += int(w.sum())
        for width in np.unique(w):
            scope = max(scope, int((w == width).sum()) * int(width)
                        * CONFIG["d"])
    assert 2.5e8 < stored < port_graph.MAX_STORE_SLOTS / 4
    assert scope < 2 ** 31 / 2
