"""The last public names of the reference that the port lacked:
``distance2_coloring``, ``masked_neighbor_sum``, ``DataGraph.replace_data``
and PageRank's ``seed`` / ``max_deg`` / ``edge_locality``, each held to
the reference on the same seeded inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_graph
from repro.apps import pagerank as ref_pagerank
from repro.core import coloring as ref_coloring
from repro.core import graph as ref_graph
from repro.core import masked_neighbor_sum as ref_masked_neighbor_sum
from repro_torch import interop
from repro_torch.apps import pagerank
from repro_torch.core import coloring, graph
from repro_torch.core.update import masked_neighbor_sum
from torch_parity import reference_arrays


def _multigraph(seed: int, n: int = 60, m: int = 150):
    """A random graph with duplicate edges (both orientations) and self
    loops."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (m, 2))
    dup = edges[rng.integers(0, m, m // 4)]
    loops = np.repeat(rng.integers(0, n, (5, 1)), 2, axis=1)
    return n, np.concatenate([edges, dup, dup[:, ::-1], loops])


@pytest.mark.parametrize("seed", range(4))
def test_distance2_coloring_is_the_references(seed):
    n, edges = _multigraph(seed)
    got = coloring.distance2_coloring(n, edges)
    want = ref_coloring.distance2_coloring(n, edges)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert coloring.verify_coloring(n, edges, got, distance=2)
    assert ref_coloring.verify_coloring(n, edges, got, distance=2)


def test_a_distance1_coloring_fails_the_distance2_check():
    n, edges = _multigraph(7)
    greedy = coloring.greedy_coloring(n, edges)
    assert coloring.verify_coloring(n, edges, greedy)
    assert not coloring.verify_coloring(n, edges, greedy, distance=2)


@pytest.mark.parametrize("f", [None, 4])
def test_masked_neighbor_sum_against_the_reference(f):
    """Bitwise at ``[B, D]``; within 1e-5 relative at ``[B, D, F]``, where
    the reference's interpret-mode fold and the plain fold may differ in
    the last bit of a float32 sum."""
    rng = np.random.default_rng(5)
    b, d = 23, 6
    w = rng.random((b, d)).astype(np.float32)
    mask = rng.random((b, d)) < 0.7
    vals = rng.normal(size=(b, d) + ((f,) if f else ())).astype(np.float32)
    want = np.asarray(ref_masked_neighbor_sum(
        jnp.asarray(w), jnp.asarray(vals), jnp.asarray(mask)))
    got = masked_neighbor_sum(torch.from_numpy(w), torch.from_numpy(vals),
                              torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if f is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_replace_data_swaps_only_what_it_is_given():
    n, edges = 40, random_graph(40, 90, seed=2)
    vdata = {"rank": np.arange(n, dtype=np.float32)}
    edata = {"w": np.linspace(0, 1, len(edges), dtype=np.float32)}
    ref = ref_graph.DataGraph.from_edges(n, edges, vdata, edata)
    port = graph.DataGraph.from_edges(n, edges, vdata, edata, device="cpu")
    new_v = np.full(n, 3.0, np.float32)
    new_e = np.full(len(edges), 0.5, np.float32)
    for kw in ({"vertex_data": {"rank": new_v}}, {"edge_data": {"w": new_e}},
               {"vertex_data": {"rank": new_v}, "edge_data": {"w": new_e}},
               {}):
        r = ref.replace_data(**{k: {kk: jnp.asarray(vv)
                                    for kk, vv in v.items()}
                                for k, v in kw.items()})
        p = port.replace_data(**{k: {kk: torch.from_numpy(vv)
                                     for kk, vv in v.items()}
                                 for k, v in kw.items()})
        want, want_meta = reference_arrays(r)
        got, got_meta = interop.graph_to_arrays(p)
        assert got_meta == want_meta and sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert p.ell is port.ell and p.colors is port.colors


@pytest.mark.parametrize("kw", [{"edge_locality": True},
                                {"edge_locality": False},
                                {"max_deg": 48, "edge_locality": True},
                                {"max_deg": 48, "seed": 3}],
                         ids=lambda kw: "-".join(f"{k}{v}"
                                                 for k, v in kw.items()))
def test_pagerank_graph_options_are_the_references(kw):
    n = 300
    edges = ref_graph.zipf_edges(n, alpha=2.0, max_deg=32, seed=2)
    want, want_meta = reference_arrays(ref_pagerank.make_graph(edges, n,
                                                               **kw))
    got, got_meta = interop.graph_to_arrays(
        pagerank.make_graph(edges, n, device="cpu", **kw))
    assert got_meta == want_meta and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    g, _, _ = pagerank.build(edges, n, device="cpu", **kw)
    assert g.max_deg == want_meta["max_deg"]
