"""The port's distributed chromatic engine, shard plans and facade
against the reference's, and against the port's own single-shard
engines.

* Every ``ShardPlan`` array is bitwise the reference's (built in this
  process: a plan needs no devices), split and unsplit.
* The port's invariants, bitwise: a distributed run equals the
  single-shard run (PageRank, split PageRank, CC), a ``LocalMesh`` equals
  eight gloo ranks of ``ProcessGroupMesh``, a chunked run the whole run.
* Against the reference's distributed engine (run in a subprocess on 8
  virtual devices): CC bitwise; PageRank within fault C2's tolerance
  (XLA fuses the combine), and bitwise once the combine is fused; CoEM
  within 1e-6; LBP with cut-edge exchange within 1e-4, equal counts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.apps import cc as ref_cc
from repro.apps import coem as ref_coem
from repro.apps import lbp as ref_lbp
from repro.apps import pagerank as ref_pagerank
from repro.core import distributed as ref_dist
from repro.core import partition as ref_partition
from repro_torch import api
from repro_torch.apps import cc, coem, lbp, pagerank
from repro_torch.core import registry
from repro_torch.core.distributed import DistributedChromaticEngine, ShardPlan
from repro_torch.core.engine_chromatic import ChromaticEngine
from repro_torch.core.graph import zipf_edges
from repro_torch.core.mesh import LocalMesh
from repro_torch.core.partition import random_partition, two_phase_partition
from torch_dist_parity import (cc_locking_job, graph80, pagerank_job,
                               run_gloo, run_reference)
from test_torch_engine import _fma_combine_update

pytestmark = pytest.mark.distributed

_REF_SCRIPT = """
    from repro.apps import cc, coem, lbp, pagerank
    from repro.core import (DistributedChromaticEngine, ShardPlan,
                            random_partition, two_phase_partition)
    out = {}
    edges = graph80()
    asg = two_phase_partition(80, edges, 8, seed=0)
    g = pagerank.make_graph(edges, 80)
    r = DistributedChromaticEngine(
        g, ShardPlan.build(g, asg, 8), pagerank.make_update(1e-5),
        syncs=[pagerank.total_rank_sync()], max_supersteps=80).run()
    out.update(pr_rank=np.asarray(r["vertex_data"]["rank"]),
               pr_counts=[r["n_updates"], r["supersteps"]],
               pr_total=np.asarray(r["globals"]["total_rank"]))
    gc, updc, _ = cc.build(edges, 80)
    r = DistributedChromaticEngine(gc, ShardPlan.build(gc, asg, 8),
                                   updc).run()
    out.update(cc_label=np.asarray(r["vertex_data"]["label"]),
               cc_counts=[r["n_updates"], r["supersteps"]])
    prob = coem.synthetic_ner(60, 40, 3, seed=2)
    plan = ShardPlan.build(
        prob.graph, random_partition(prob.graph.n_vertices, 8, seed=3), 8)
    r = DistributedChromaticEngine(prob.graph, plan, coem.make_update(1e-4),
                                   max_supersteps=40).run()
    out.update(coem_p=np.asarray(r["vertex_data"]["p"]),
               coem_counts=[r["n_updates"], r["supersteps"]])
    pl = lbp.synthetic_coseg(4, 3, 4, n_labels=3, noise=0.5)
    r = DistributedChromaticEngine(
        pl.graph, ShardPlan.build(pl.graph, lbp.frame_partition(pl, 8), 8),
        lbp.make_update(3, eps=1e-3, use_gmm_sync=False), max_supersteps=25,
        exchange_edges=True).run()
    out.update(lbp_belief=np.asarray(r["vertex_data"]["belief"]),
               lbp_counts=[r["n_updates"], r["supersteps"]])
    np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_REF_SCRIPT,
                         tmp_path_factory.mktemp("ref") / "chromatic.npz")


def _pr80(eps=1e-5, **kw):
    return pagerank.make_graph(graph80(), 80, device="cpu", **kw)


def _plan(g, edges, m):
    return ShardPlan.build(g, two_phase_partition(g.n_vertices, edges, m,
                                                  seed=0), m)


# ----------------------------------------------------------------------
# ShardPlan: bitwise the reference's
# ----------------------------------------------------------------------

_SCALARS = ("M", "R", "E_loc", "n_colors", "Cmax", "Hv", "He", "Hg", "Hc",
            "ell_max_deg", "ell_w_cap", "ell_n_chunks_max")
_ARRAYS = ("degree", "owned_mask", "color_ids", "color_valid", "send_idx",
           "send_mask", "recv_idx", "esend_idx", "esend_mask", "erecv_idx",
           "tsend_idx", "tsend_mask", "trecv_idx", "global_ids",
           "cesend_idx", "cesend_mask", "cerecv_idx", "local_to_global",
           "ledge_to_global", "assignment")


_PLAN_CASES = ("graph80-M1", "graph80-M3", "graph80-M8", "zipf",
               "zipf-split", "zipf-split-M1", "lbp-frame", "coem-random",
               "cc-colorless")


def _plan_case(name):
    """(reference graph, port graph, assignment, M) of a plan case."""
    e80 = graph80()
    z = zipf_edges(80, alpha=2.0, max_deg=32, seed=7)
    if name.startswith("graph80"):
        m = int(name[-1])
        return (ref_pagerank.make_graph(e80, 80), _pr80(),
                ref_partition.two_phase_partition(80, e80, m, seed=0), m)
    if name == "zipf-split-M1":
        return (ref_pagerank.make_graph(z, 80, w_cap=4),
                pagerank.make_graph(z, 80, w_cap=4, device="cpu"),
                np.zeros(80, np.int64), 1)
    if name.startswith("zipf"):
        kw = dict(w_cap=8) if name == "zipf-split" else {}
        return (ref_pagerank.make_graph(z, 80, **kw),
                pagerank.make_graph(z, 80, device="cpu", **kw),
                ref_partition.two_phase_partition(80, z, 8, seed=0), 8)
    if name == "lbp-frame":
        pl = ref_lbp.synthetic_coseg(4, 3, 4, n_labels=3, noise=0.5)
        tl = lbp.synthetic_coseg(4, 3, 4, n_labels=3, noise=0.5,
                                 device="cpu")
        return pl.graph, tl.graph, ref_lbp.frame_partition(pl, 8), 8
    if name == "coem-random":
        ner = ref_coem.synthetic_ner(60, 40, 3, seed=2)
        tner = coem.synthetic_ner(60, 40, 3, seed=2, device="cpu")
        return (ner.graph, tner.graph, ref_partition.random_partition(
            ner.graph.n_vertices, 8, seed=3), 8)
    # colorless: the trivial one-color schedule
    rc, _, _ = ref_cc.build(e80, 80)
    tc, _, _ = cc.build(e80, 80, device="cpu")
    return (dataclasses.replace(rc, colors=None),
            dataclasses.replace(tc, colors=None),
            ref_partition.random_partition(80, 5, seed=1), 5)


@pytest.mark.parametrize("name", _PLAN_CASES)
def test_plan_arrays_bitwise(name):
    rg, tg, asg, m = _plan_case(name)
    want = ref_dist.ShardPlan.build(rg, asg, m)
    got = ShardPlan.build(tg, asg, m)
    for f in _SCALARS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.ell_widths == tuple(want.ell_widths)
    assert got.ell_starts == tuple(want.ell_starts)
    for f in _ARRAYS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    arrays = got.ell_arrays()
    for key, blocks in want.ell_arrays().items():
        if isinstance(blocks, tuple):
            assert len(arrays[key]) == len(blocks)
            for a, b in zip(arrays[key], blocks):
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=key)
        else:
            np.testing.assert_array_equal(arrays[key], np.asarray(blocks),
                                          err_msg=key)
    assert got.partition_fingerprint == want.partition_fingerprint
    assert (got.sliced_slots, got.bucket_launches) == (
        want.sliced_slots, want.bucket_launches)


def test_shard_data_round_trips_like_the_reference():
    rg, tg, asg, m = _plan_case("lbp-frame")
    want = ref_dist.ShardPlan.build(rg, asg, m)
    got = ShardPlan.build(tg, asg, m)
    v = {"belief": tg.vertex_data["belief"] - 1.0}
    sv = got.shard_vertex_data(v)
    rv = want.shard_vertex_data({"belief": np.asarray(v["belief"])})
    np.testing.assert_array_equal(sv["belief"].numpy(),
                                  np.asarray(rv["belief"]))
    e = {k: a[:-1] for k, a in tg.edge_data.items()}
    se = got.shard_edge_data(e)
    re = want.shard_edge_data({k: np.asarray(a) for k, a in e.items()})
    for k in e:
        np.testing.assert_array_equal(se[k].numpy(), np.asarray(re[k]))
    back = got.unshard_vertex_data(sv, tg.n_vertices)
    assert torch.equal(back["belief"], v["belief"])


def test_shard_data_of_some_shards_only():
    """A process driving some shards cuts only those rows out: the
    ``shards=`` rows of the whole ``[M, ...]`` result."""
    _, tg, asg, m = _plan_case("lbp-frame")
    plan = ShardPlan.build(tg, asg, m)
    v = {"belief": tg.vertex_data["belief"] - 1.0}
    e = {k: a[:-1] for k, a in tg.edge_data.items()}
    mine = [m - 1, 2]
    for all_, some in ((plan.shard_vertex_data(v),
                        plan.shard_vertex_data(v, mine)),
                       (plan.shard_edge_data(e),
                        plan.shard_edge_data(e, mine))):
        for k in all_:
            assert torch.equal(some[k], all_[k][mine])


# ----------------------------------------------------------------------
# The port's invariants: distributed == single shard, meshes agree
# ----------------------------------------------------------------------

def _single_and_dist(kind):
    """(single-shard state, distributed result) of each bitwise case."""
    e80 = graph80()
    if kind == "pagerank":
        g, upd = _pr80(), pagerank.make_update(1e-5)
        syncs, plan = [pagerank.total_rank_sync()], _plan(_pr80(), e80, 8)
    elif kind == "pagerank-split":
        z = zipf_edges(80, alpha=2.0, max_deg=32, seed=7)
        g = pagerank.make_graph(z, 80, w_cap=8, device="cpu")
        upd, syncs, plan = pagerank.make_update(1e-4), [], _plan(g, z, 8)
    elif kind == "pagerank-3dev":
        g, upd = _pr80(), pagerank.make_update(1e-5)
        syncs, plan = [pagerank.total_rank_sync()], _plan(_pr80(), e80, 3)
    else:
        g, upd, syncs = cc.build(e80, 80, device="cpu")
        plan = _plan(g, e80, 8)
    single = ChromaticEngine(g, upd, syncs=syncs, max_supersteps=80).run()
    # "pagerank-3dev": shards on two distinct device objects, so the
    # mesh copies between devices instead of transposing in place
    mesh = (LocalMesh(plan.M, ["cpu", torch.device("cpu", 0)])
            if kind == "pagerank-3dev" else None)
    dist = DistributedChromaticEngine(g, plan, upd, syncs=syncs,
                                      max_supersteps=80, mesh=mesh).run()
    return single, dist


@pytest.mark.parametrize("kind", ["pagerank", "pagerank-split",
                                  "pagerank-3dev", "cc"])
def test_distributed_equals_single_shard_bitwise(kind):
    single, dist = _single_and_dist(kind)
    for k, v in single.vertex_data.items():
        assert torch.equal(v, dist["vertex_data"][k]), k
    assert (int(single.n_updates), single.superstep) == (
        dist["n_updates"], dist["supersteps"])
    assert not dist["active_any"]


def test_chunked_run_equals_the_whole_run():
    g, upd, syncs = _pr80(), pagerank.make_update(1e-5), [
        pagerank.total_rank_sync()]
    eng = DistributedChromaticEngine(g, _plan(g, graph80(), 4), upd,
                                     syncs=syncs, max_supersteps=80)
    whole = eng.run()
    carry = eng.init_carry()
    for stop in (3, 7, 80):
        carry = eng.step_chunk(carry, stop)
    got = eng.finalize(carry)
    assert torch.equal(got["vertex_data"]["rank"], whole["vertex_data"]["rank"])
    assert (got["n_updates"], got["supersteps"]) == (whole["n_updates"],
                                                     whole["supersteps"])
    assert got["globals"]["total_rank"] == whole["globals"]["total_rank"]


@pytest.mark.parametrize("job", ["pagerank", "cc_locking"])
def test_local_mesh_equals_eight_gloo_ranks(job, tmp_path):
    """The same per-shard program over ``torch.distributed`` (8 gloo
    CPU processes, one shard each) and over a ``LocalMesh``: bitwise."""
    fn = {"pagerank": pagerank_job, "cc_locking": cc_locking_job}[job]
    local = fn(LocalMesh(8, ["cpu"]))
    ranks = run_gloo(job, 8, tmp_path)
    assert set(ranks) == set(local)
    for k, v in local.items():
        np.testing.assert_array_equal(ranks[k], np.asarray(v), err_msg=k)


def test_process_group_mesh_refuses_what_its_backend_cannot_do():
    from repro_torch.core.mesh import ProcessGroupMesh
    with pytest.raises(ValueError, match="initialized process group"):
        ProcessGroupMesh()
    with pytest.raises(ValueError, match="n_shards"):
        LocalMesh(0, ["cpu"])
    with pytest.raises(ValueError, match=r"\[M=2"):
        LocalMesh(2, ["cpu"]).all_to_all([torch.zeros(3, 1)] * 2)


# ----------------------------------------------------------------------
# Against the reference's distributed engine
# ----------------------------------------------------------------------

def _run_port(kind, upd=None):
    e80 = graph80()
    asg = two_phase_partition(80, e80, 8, seed=0)
    if kind == "pagerank":
        g = _pr80()
        return DistributedChromaticEngine(
            g, ShardPlan.build(g, asg, 8), upd or pagerank.make_update(1e-5),
            syncs=[pagerank.total_rank_sync()], max_supersteps=80).run()
    if kind == "cc":
        g, updc, _ = cc.build(e80, 80, device="cpu")
        return DistributedChromaticEngine(g, ShardPlan.build(g, asg, 8),
                                          updc).run()
    if kind == "coem":
        prob = coem.synthetic_ner(60, 40, 3, seed=2, device="cpu")
        plan = ShardPlan.build(
            prob.graph, random_partition(prob.graph.n_vertices, 8, seed=3), 8)
        return DistributedChromaticEngine(
            prob.graph, plan, coem.make_update(1e-4), max_supersteps=40).run()
    pl = lbp.synthetic_coseg(4, 3, 4, n_labels=3, noise=0.5, device="cpu")
    return DistributedChromaticEngine(
        pl.graph, ShardPlan.build(pl.graph, lbp.frame_partition(pl, 8), 8),
        lbp.make_update(3, eps=1e-3, use_gmm_sync=False), max_supersteps=25,
        exchange_edges=True).run()


def test_cc_matches_reference_bitwise(ref):
    got = _run_port("cc")
    np.testing.assert_array_equal(got["vertex_data"]["label"].numpy(),
                                  ref["cc_label"])
    assert [got["n_updates"], got["supersteps"]] == ref["cc_counts"].tolist()


def test_pagerank_matches_reference_within_c2(ref):
    """Fault C2: XLA fuses ``ALPHA + (1 - ALPHA) * y``, eager torch does
    not, so ranks may differ by ulps; held to 10 eps as the single-shard
    parity test holds them."""
    got = _run_port("pagerank")
    np.testing.assert_allclose(got["vertex_data"]["rank"].numpy(),
                               ref["pr_rank"], rtol=0, atol=1e-4)
    assert got["globals"]["total_rank"].item() == pytest.approx(
        float(ref["pr_total"]), rel=1e-5)


def test_pagerank_bitwise_with_reference_once_the_combine_is_fused(ref):
    got = _run_port("pagerank", _fma_combine_update(1e-5))
    np.testing.assert_array_equal(got["vertex_data"]["rank"].numpy(),
                                  ref["pr_rank"])
    assert [got["n_updates"], got["supersteps"]] == ref["pr_counts"].tolist()


def test_coem_matches_reference(ref):
    got = _run_port("coem")
    assert np.abs(got["vertex_data"]["p"].numpy()
                  - ref["coem_p"]).max() < 1e-6


def test_lbp_with_edge_exchange_matches_reference(ref):
    got = _run_port("lbp")
    assert np.abs(got["vertex_data"]["belief"].numpy()
                  - ref["lbp_belief"]).max() < 1e-4
    assert [got["n_updates"], got["supersteps"]] == ref["lbp_counts"].tolist()


# ----------------------------------------------------------------------
# The facade and the registry
# ----------------------------------------------------------------------

class _FlatModel:
    """A cost model that prices every launch alike and syncs at 1 us a
    row: ``two_phase_partition`` then picks the candidate with the
    fewest ghost rows on its busiest shard."""
    sync_cost_us = 1.0

    def predict_launches(self, launches):
        return float(len(launches))

    def predict(self, width, rows):
        return 1.0


def test_facade_partition_forms_agree():
    """``partition=`` as None (two-phase, seed 0), an assignment, a
    callable, a ``ShardPlan`` and ``"measured"``: the same engine run,
    bitwise."""
    e80 = graph80()
    g, upd, syncs = pagerank.build(e80, 80, eps=1e-3, device="cpu")
    asg = two_phase_partition(80, g.edges_np, 4, seed=0)
    runs = [api.run(g, upd, syncs=syncs, n_shards=4, device="cpu",
                    partition=p)
            for p in (None, asg, lambda graph, m: asg,
                      ShardPlan.build(g, asg, 4))]
    for r in runs[1:]:
        assert torch.equal(r.vertex_data["rank"], runs[0].vertex_data["rank"])
        assert (r.n_updates, r.superstep) == (runs[0].n_updates,
                                              runs[0].superstep)
    measured = api.run(g, upd, syncs=syncs, n_shards=4, device="cpu",
                       partition="measured", cost_model=_FlatModel())
    want = ref_partition.two_phase_partition(
        80, g.edges_np, 4, seed=0, cost_model=_FlatModel())
    np.testing.assert_array_equal(measured.engine.plan.assignment, want)
    assert set(runs[0].stats) == {"local_vertex_data", "local_edge_data"}
    assert isinstance(runs[0].engine, DistributedChromaticEngine)


def test_facade_errors_are_the_references(monkeypatch, tmp_path):
    e80 = graph80()
    g, upd, syncs = pagerank.build(e80, 80, eps=1e-5, device="cpu")
    rg, rupd, rsyncs = ref_pagerank.build(e80, 80, eps=1e-5)
    asg = two_phase_partition(80, e80, 4, seed=0)

    def both(port_kw, ref_kw=None, fix=lambda s: s):
        with pytest.raises(ValueError) as p:
            api.build_engine(g, upd, syncs=syncs, device="cpu", **port_kw)
        with pytest.raises(ValueError) as r:
            ref_api.build_engine(rg, rupd, syncs=rsyncs,
                                 **(ref_kw or port_kw))
        assert str(p.value) == fix(str(r.value))

    both(dict(n_shards=8, partition=ShardPlan.build(g, asg, 4)),
         dict(n_shards=8, partition=ref_dist.ShardPlan.build(rg, asg, 4)))
    both(dict(n_shards=2, partition="metis"))
    both(dict(scheduler="priority", n_shards=2, k_select=8))
    monkeypatch.setenv("REPRO_TORCH_RESULTS_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_RESULTS_DIR", str(tmp_path))
    both(dict(n_shards=2, partition="measured"),
         fix=lambda s: s.replace("repro.profile", "repro_torch.profile"))
    # the distributed entry's option set: the reference's, with its
    # shard_map axis name and Pallas switch replaced by the mesh
    with pytest.raises(ValueError) as p:
        api.build_engine(g, upd, scheduler="locking", n_shards=2,
                         k_select=3, device="cpu")
    with pytest.raises(ValueError) as r:
        ref_api.build_engine(rg, rupd, scheduler="locking", n_shards=2,
                             k_select=3)
    head = "scheduler 'locking' (distributed) does not accept ['k_select']"
    assert str(p.value).startswith(head) and str(r.value).startswith(head)
    for kw in (dict(until=lambda gl: True), dict(priority=np.ones(80))):
        with pytest.raises(ValueError, match="single-device"):
            api.run(g, upd, n_shards=2, device="cpu", **kw)


def test_registry_distributed_entries():
    from repro_torch.core.engine_locking import DistributedLockingEngine
    assert registry.get_distributed("chromatic").factory is \
        DistributedChromaticEngine
    entry = registry.get_distributed("locking")
    assert entry.factory is DistributedLockingEngine
    assert entry.allowed == frozenset(registry.SHARED_DIST_KWARGS
                                      + ("max_pending",))
    assert registry.register_distributed(
        "locking", DistributedLockingEngine) is entry
    with pytest.raises(ValueError, match="already registered"):
        registry.register_distributed("locking", object)


@pytest.mark.parametrize("shape,m", [((4, 3, 4), 8), ((6, 2, 3), 4),
                                     ((5, 3, 3), 3)])
def test_lbp_partitions_are_the_references(shape, m):
    rp = ref_lbp.synthetic_coseg(*shape, n_labels=3)
    tp = lbp.synthetic_coseg(*shape, n_labels=3, device="cpu")
    for name in ("frame_partition", "striped_partition"):
        np.testing.assert_array_equal(getattr(lbp, name)(tp, m),
                                      getattr(ref_lbp, name)(rp, m))
