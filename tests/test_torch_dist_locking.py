"""The port's distributed locking engine against the reference's and
against the port's single-shard ``LockingEngine``.

* Port invariants, bitwise: with a saturating window (``max_pending =
  R`` a shard against ``Nv`` on one device) the distributed run equals
  the single-shard one (PageRank, split PageRank, CC); one shard equals
  ``LockingEngine`` at any window; the batch-shaped claim pass equals
  the bucket-shaped one.
* Against the reference's engine on 8 virtual devices (a subprocess):
  PageRank bitwise once the combine is fused (fault C2), ghost traffic
  included, and the versioned sync ships strictly less than the static
  schedule; CoSeg LBP with cut-edge exchange within 1e-4 with equal
  counts, the frame partition and the striped worst case; the FULL
  refusal across shards.
"""
import numpy as np
import pytest
import torch

from repro.apps import pagerank as ref_pagerank
from repro.core import distributed as ref_dist
from repro.core import engine_locking as ref_locking
from repro.core.update import Consistency as RefConsistency
from repro_torch.apps import cc, lbp, pagerank
from repro_torch.core.distributed import ShardPlan
from repro_torch.core.engine_chromatic import ChromaticEngine
from repro_torch.core.engine_locking import (DistributedLockingEngine,
                                             LockingEngine)
from repro_torch.core.graph import zipf_edges
from repro_torch.core.partition import two_phase_partition
from repro_torch.core.update import Consistency
from test_torch_engine import _fma_combine_update
from torch_dist_parity import graph80, run_reference

pytestmark = pytest.mark.distributed

EPS = 1e-2      # PageRank's threshold here: 74 supersteps saturated

_REF_SCRIPT = f"""
    from repro.apps import lbp, pagerank
    from repro.core import (DistributedLockingEngine, ShardPlan,
                            two_phase_partition)
    out = {{}}
    edges = graph80()
    g = pagerank.make_graph(edges, 80)
    plan = ShardPlan.build(g, two_phase_partition(80, edges, 8, seed=0), 8)
    r = DistributedLockingEngine(
        g, plan, pagerank.make_update({EPS}),
        syncs=[pagerank.total_rank_sync()], max_pending=plan.R,
        max_supersteps=3000).run()
    out.update(pr_rank=np.asarray(r["vertex_data"]["rank"]),
               pr_counts=[r["n_updates"], r["supersteps"]],
               pr_ghost=[r["ghost_rows_sent"], r["ghost_rows_full"]])
    pl = lbp.synthetic_coseg(4, 3, 4, n_labels=3, noise=0.5)
    planl = ShardPlan.build(pl.graph, lbp.frame_partition(pl, 8), 8)
    r = DistributedLockingEngine(
        pl.graph, planl, lbp.make_update(3, eps=1e-2, use_gmm_sync=False),
        max_pending=planl.R, max_supersteps=3000, exchange_edges=True).run()
    out.update(lbp_belief=np.asarray(r["vertex_data"]["belief"]),
               lbp_counts=[r["n_updates"], r["supersteps"]])
    r = lbp.distributed_locking_engine(pl, 8, max_pending=planl.R,
                                       worst_case=True).run()
    out.update(striped_belief=np.asarray(r["vertex_data"]["belief"]),
               striped_counts=[r["n_updates"], r["ghost_rows_sent"],
                               r["ghost_rows_full"]])
    np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_REF_SCRIPT,
                         tmp_path_factory.mktemp("ref") / "locking.npz")


def _plan(g, edges, m):
    return ShardPlan.build(g, two_phase_partition(g.n_vertices, edges, m,
                                                  seed=0), m)


def _case(kind):
    """(graph, update, syncs, plan) of each saturating-window case."""
    e80 = graph80()
    if kind == "pagerank":
        g = pagerank.make_graph(e80, 80, device="cpu")
        return (g, pagerank.make_update(EPS), [pagerank.total_rank_sync()],
                _plan(g, e80, 8))
    if kind == "pagerank-split":
        z = zipf_edges(80, alpha=2.0, max_deg=32, seed=7)
        g = pagerank.make_graph(z, 80, w_cap=8, device="cpu")
        return g, pagerank.make_update(EPS), [], _plan(g, z, 8)
    g, upd, syncs = cc.build(e80, 80, device="cpu")
    return g, upd, syncs, _plan(g, e80, 8)


@pytest.mark.parametrize("kind", ["pagerank", "pagerank-split", "cc"])
def test_saturating_window_equals_single_shard_bitwise(kind):
    g, upd, syncs, plan = _case(kind)
    single = LockingEngine(g, upd, syncs=syncs, max_pending=g.n_vertices,
                           max_supersteps=3000).run()
    dist = DistributedLockingEngine(g, plan, upd, syncs=syncs,
                                    max_pending=plan.R,
                                    max_supersteps=3000).run()
    for k, v in single.vertex_data.items():
        assert torch.equal(v, dist["vertex_data"][k]), k
    assert (int(single.n_updates), single.superstep) == (
        dist["n_updates"], dist["supersteps"])
    assert 0 < dist["ghost_rows_sent"] < dist["ghost_rows_full"]


def test_one_shard_equals_the_locking_engine_at_any_window():
    g, upd, syncs, _ = _case("pagerank")
    single = LockingEngine(g, upd, syncs=syncs, max_pending=8,
                           max_supersteps=5000).run()
    plan = ShardPlan.build(g, np.zeros(80, np.int64), 1)
    dist = DistributedLockingEngine(g, plan, upd, syncs=syncs, max_pending=8,
                                    max_supersteps=5000).run()
    assert torch.equal(single.vertex_data["rank"], dist["vertex_data"]["rank"])
    assert (int(single.n_updates), single.superstep) == (
        dist["n_updates"], dist["supersteps"])
    # no ghosts on one shard: the versioned sync moves nothing
    assert dist["ghost_rows_sent"] == dist["ghost_rows_full"] == 0


@pytest.mark.parametrize("kind", ["pagerank", "pagerank-split"])
def test_batch_claim_pass_equals_bucket_claim_pass(kind):
    """A small window takes the window-shaped claim pass and launches
    (the combine between two width switches); forcing the bucket shape
    gives the same run, bitwise."""
    g, upd, syncs, plan = _case(kind)
    runs = [DistributedLockingEngine(g, plan, upd, syncs=syncs, max_pending=4,
                                     dispatch=d).run(num_supersteps=60)
            for d in ("batch", "bucket")]
    assert runs[0]["vertex_data"]["rank"].equal(runs[1]["vertex_data"]["rank"])
    assert runs[0]["n_updates"] == runs[1]["n_updates"]
    assert runs[0]["ghost_rows_sent"] == runs[1]["ghost_rows_sent"]


def test_pipelined_window_converges_to_the_fixed_point():
    g, _, _, plan = _case("pagerank")
    upd = pagerank.make_update(1e-4)
    chrom = ChromaticEngine(g, upd, max_supersteps=300).run()
    small = DistributedLockingEngine(g, plan, upd, max_pending=8,
                                     max_supersteps=20000).run()
    assert not small["active_any"]
    assert (chrom.vertex_data["rank"]
            - small["vertex_data"]["rank"]).abs().max() < 2e-3


def test_pagerank_and_ghost_traffic_bitwise_the_reference(ref):
    """With the combine fused as XLA fuses it (fault C2), the run is the
    reference's: ranks, counts and the versioned sync's traffic."""
    g, _, syncs, plan = _case("pagerank")
    got = DistributedLockingEngine(g, plan, _fma_combine_update(EPS),
                                   syncs=syncs, max_pending=plan.R,
                                   max_supersteps=3000).run()
    np.testing.assert_array_equal(got["vertex_data"]["rank"].numpy(),
                                  ref["pr_rank"])
    assert [got["n_updates"], got["supersteps"]] == ref["pr_counts"].tolist()
    assert [got["ghost_rows_sent"], got["ghost_rows_full"]] == \
        ref["pr_ghost"].tolist()


def test_versioned_ghost_sync_filters_traffic(ref):
    """The paper's "only transmit modified data": strictly less than the
    static every-round schedule, in the port as in the reference."""
    g, upd, syncs, plan = _case("pagerank")
    got = DistributedLockingEngine(g, plan, upd, syncs=syncs,
                                   max_pending=plan.R,
                                   max_supersteps=3000).run()
    sent, full = ref["pr_ghost"].tolist()
    assert 0 < sent < full
    assert 0 < got["ghost_rows_sent"] < got["ghost_rows_full"]
    np.testing.assert_allclose(got["vertex_data"]["rank"].numpy(),
                               ref["pr_rank"], rtol=0, atol=10 * EPS)


def test_lbp_with_edge_exchange_matches_reference(ref):
    pl = lbp.synthetic_coseg(4, 3, 4, n_labels=3, noise=0.5, device="cpu")
    plan = ShardPlan.build(pl.graph, lbp.frame_partition(pl, 8), 8)
    got = DistributedLockingEngine(
        pl.graph, plan, lbp.make_update(3, eps=1e-2, use_gmm_sync=False),
        max_pending=plan.R, max_supersteps=3000, exchange_edges=True).run()
    assert np.abs(got["vertex_data"]["belief"].numpy()
                  - ref["lbp_belief"]).max() < 1e-4
    assert [got["n_updates"], got["supersteps"]] == ref["lbp_counts"].tolist()


def test_striped_worst_case_helper_matches_reference(ref):
    pl = lbp.synthetic_coseg(4, 3, 4, n_labels=3, noise=0.5, device="cpu")
    frame = ShardPlan.build(pl.graph, lbp.frame_partition(pl, 8), 8)
    eng = lbp.distributed_locking_engine(pl, 8, max_pending=frame.R,
                                         worst_case=True)
    assert eng.exchange_edges and eng.plan.M == 8
    np.testing.assert_array_equal(eng.plan.assignment,
                                  lbp.striped_partition(pl, 8))
    got = eng.run()
    assert np.abs(got["vertex_data"]["belief"].numpy()
                  - ref["striped_belief"]).max() < 1e-4
    assert [got["n_updates"], got["ghost_rows_sent"],
            got["ghost_rows_full"]] == ref["striped_counts"].tolist()


def test_full_consistency_is_refused_across_shards():
    import dataclasses
    e80 = graph80()
    g, upd, _ = cc.build(e80, 80, device="cpu")
    full = dataclasses.replace(upd, consistency=Consistency.FULL)
    with pytest.raises(ValueError) as got:
        DistributedLockingEngine(g, _plan(g, e80, 2), full)
    rg = ref_pagerank.make_graph(e80, 80)
    rupd = dataclasses.replace(ref_pagerank.make_update(1e-3),
                               consistency=RefConsistency.FULL)
    with pytest.raises(ValueError) as want:
        ref_locking.DistributedLockingEngine(
            rg, ref_dist.ShardPlan.build(
                rg, np.arange(80) % 2, 2), rupd)
    assert str(got.value) == str(want.value)
    # one shard may write its neighbours: there are no ghosts
    DistributedLockingEngine(g, _plan(g, e80, 1), full)

