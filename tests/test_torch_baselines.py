"""The port's MapReduce baselines against the reference's (paper §6.2).

The same problems (built from the same seeds, so array for array the
reference's) go through ``repro.baselines.mapreduce`` and
``repro_torch.baselines.mapreduce``.  Both sum each destination's
messages in edge order (the port through ``segment_sum_csr`` over
destination-sorted edges), so the normal equations agree bitwise; the
factors pass through LAPACK's LU in the port and XLA's in the reference,
so they are held to atol = 1e-5, as are the CoEM tables (the
normalization's row sums may be taken in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.apps import als as ref_als
from repro.apps import coem as ref_coem
from repro.baselines import mapreduce as ref_mr
from repro_torch import api
from repro_torch.apps import als, coem
from repro_torch.baselines import mapreduce as mr


@pytest.mark.parametrize("n_iters", [1, 6])
def test_als_mapreduce_matches_reference(n_iters):
    args = dict(d=3, density=0.4, noise=0.05, seed=4)
    want, want_stats = ref_mr.als_mapreduce(
        ref_als.synthetic_netflix(25, 20, **args), n_iters, lam=0.02)
    got, got_stats = mr.als_mapreduce(
        als.synthetic_netflix(25, 20, device="cpu", **args), n_iters,
        lam=0.02)
    for k in ("w_users", "w_movies"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)
    assert dataclasses.asdict(got_stats) == dataclasses.asdict(want_stats)


def test_coem_mapreduce_matches_reference():
    args = dict(mean_deg=8, seed_frac=0.15, seed=1)
    want, want_stats = ref_mr.coem_mapreduce(
        ref_coem.synthetic_ner(120, 80, 3, **args), 30)
    got, got_stats = mr.coem_mapreduce(
        coem.synthetic_ner(120, 80, 3, device="cpu", **args), 30)
    np.testing.assert_allclose(got["p"].numpy(), np.asarray(want["p"]),
                               rtol=0, atol=1e-5)
    assert dataclasses.asdict(got_stats) == dataclasses.asdict(want_stats)


def test_shuffle_groups_edges_by_destination_in_edge_order():
    rng = np.random.default_rng(2)
    dst = rng.integers(0, 9, 200)
    src = rng.integers(0, 50, 200)
    sh = mr.Shuffle.by_destination(dst, src, 10, "cpu")
    order, offsets = sh.order.numpy(), sh.offsets.numpy()
    assert offsets[0] == 0 and offsets[-1] == 200 and offsets[-2] == 200
    for r in range(10):
        seg = order[offsets[r]:offsets[r + 1]]
        np.testing.assert_array_equal(seg, np.nonzero(dst == r)[0])
    np.testing.assert_array_equal(sh.src.numpy(), src[order])
    np.testing.assert_array_equal(sh.counts().numpy(),
                                  np.bincount(dst, minlength=10))


def test_mapreduce_als_matches_chromatic_trajectory():
    """Non-adaptive chromatic ALS (eps = 0, full sweeps) with the movies
    colored first computes the alternating MR jobs: the two programming
    models run one algorithm (the mirror of tests/test_baselines.py),
    factors within 1e-4."""
    prob = als.synthetic_netflix(25, 20, d=3, density=0.4, noise=0.05,
                                 seed=4, device="cpu")
    colors = 1 - prob.graph.colors.numpy()          # movies = color 0
    g = prob.graph.with_colors(colors)
    st = api.run(g, als.make_update(3, lam=0.02, eps=0.0),
                 scheduler="chromatic", num_supersteps=6, device="cpu")
    out, stats = mr.als_mapreduce(prob, 6, lam=0.02)
    w_mr = torch.cat([out["w_users"], out["w_movies"]])
    np.testing.assert_allclose(st.vertex_data["w"].numpy(), w_mr.numpy(),
                               atol=1e-4)
    assert stats.bytes_shuffled_per_iter == 2 * len(prob.pairs) * (3 + 1) * 4
    assert stats.messages_per_iter == 2 * len(prob.pairs)


def test_mapreduce_coem_reaches_same_accuracy():
    """The mirror of tests/test_baselines.py: MapReduce CoEM and the
    chromatic engine label the corpus within 0.05 of each other."""
    prob = coem.synthetic_ner(120, 80, 3, mean_deg=8, seed_frac=0.15,
                              seed=1, device="cpu")
    st = api.run(prob.graph, coem.make_update(0.0), scheduler="chromatic",
                 num_supersteps=30, device="cpu")
    out, _ = mr.coem_mapreduce(prob, 30)
    acc_eng = coem.label_accuracy(prob, st.vertex_data)
    acc_mr = coem.label_accuracy(prob, {"p": out["p"]})
    assert abs(acc_eng - acc_mr) < 0.05
