"""The plain reference against the port's output at small sizes, and
the generator's sizes across seeds."""
import numpy as np
import pytest
import torch

from bench.gen import zipf
from bench.reference import pagerank as ref_pr

CPU = torch.device("cpu")


def test_fixed_point_matches_the_ports_float64_oracle():
    from repro_torch.apps import pagerank
    edges = zipf.zipf_edges(torch, 300, 2.0, 5, CPU).numpy()
    mine = ref_pr.fixed_point(edges, 300, 0.15, CPU).numpy()
    theirs = pagerank.reference_pagerank(edges, 300, n_iters=400)
    np.testing.assert_allclose(mine, theirs, rtol=1e-12, atol=0)


@pytest.mark.parametrize("scheduler", ["chromatic", "bsp"])
def test_port_pagerank_is_near_the_fixed_point(scheduler):
    from repro_torch import api
    from repro_torch.apps import pagerank
    n = 400
    edges = zipf.zipf_edges(torch, n, 2.0, 6, CPU).numpy()
    g, upd, syncs = pagerank.build(edges, n, eps=1e-4, device="cpu")
    res = api.run(g, upd, syncs=syncs, scheduler=scheduler, device="cpu")
    best = ref_pr.fixed_point(edges, n, 0.15, CPU).numpy()
    nums = ref_pr.compare(best, res.vertex_data["rank"].numpy(),
                          float(res.globals["total_rank"]),
                          float(res.globals["top2"][0]))
    assert not res.active_any
    assert nums["rank_gap_max"] < 2e-3 and nums["rank_gap_mean"] < 5e-4
    assert nums["total_rank_gap"] < 1e-6 and nums["top2_gap"] == 0.0


def test_degrees_are_the_unclipped_law_in_one_layout():
    q = zipf.degree_quantiles(torch, 1000, 2.0, CPU)
    assert q.min() == 1 and q.max() == 999 and (q[1:] >= q[:-1]).all()
    # the law's median is 1: P(1) = 1 / zeta(2) = 0.61
    assert int(q[499]) == 1 and int(q[620]) == 2
    a = zipf.degrees(torch, 1000, 2.0, CPU)
    assert torch.equal(a, zipf.degrees(torch, 1000, 2.0, CPU))
    assert torch.equal(a.sort().values, q)
    assert not torch.equal(a, q)                  # placed, not sorted


def test_seeds_pair_the_same_stubs_differently():
    n = 2000
    law = zipf.degrees(torch, n, 2.0, CPU)
    graphs = [zipf.zipf_edges(torch, n, 2.0, s, CPU) for s in (1, 2 ** 33 + 1)]
    assert not torch.equal(*graphs)
    assert torch.equal(graphs[0], zipf.zipf_edges(torch, n, 2.0, 1, CPU))
    for e in graphs:
        key = e[:, 0] * n + e[:, 1]
        assert (e[:, 0] < e[:, 1]).all()
        assert torch.equal(key, torch.unique(key))    # sorted, no repeats
        deg = torch.bincount(e.view(-1), minlength=n)
        # pairing drops only self loops and repeats
        assert (deg <= law).all()
        assert deg.sum() >= 0.5 * law.sum()     # hubs lose repeats
