"""The port's partitioner and shard-shape builders against the
reference's (host-side numpy, paper §4.1).

For the same inputs and seed every assignment is bitwise the
reference's: two-phase (atoms by BFS, the meta-graph, LPT balancing),
with vertex weights, with a cost model arbitrating between candidates,
and the random baseline.  The port's one sliced-ELL builder works on
row slot lists (``sliced_ell_from_slots``, ``split_ell_from_slots``):
its forced shard shapes (``bucket_sizes=``, ``n_virtual=``) are
bitwise the reference's padded ``build_sliced_ell`` /
``build_split_ell``, also on rows read back from a stored graph
(``row_slots``), and the padded builders reach it through
``padded_slots``.
"""
import numpy as np
import pytest

from repro.core import graph as ref_graph
from repro.core import partition as ref_part
from repro_torch.core import graph, partition
from repro_torch.core.graph import grid_edges_3d, zipf_edges
from conftest import random_graph
from torch_dist_parity import graph80


def _graphs():
    nv_g, grid = grid_edges_3d(4, 6, 6)
    return {
        "random60": (60, random_graph(60, 150, seed=7)),
        "graph80": (80, graph80()),
        "zipf2000": (2000, zipf_edges(2000, alpha=2.0, max_deg=64, seed=1)),
        "grid": (nv_g, grid),
        "sparse": (50, random_graph(50, 20, seed=3)),   # isolated vertices
    }


GRAPHS = _graphs()


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("m", [1, 2, 3, 8])
def test_two_phase_assignment_bitwise(name, m):
    nv, edges = GRAPHS[name]
    for seed in (0, 5):
        want = ref_part.two_phase_partition(nv, edges, m, seed=seed)
        got = partition.two_phase_partition(nv, edges, m, seed=seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["zipf2000", "graph80"])
def test_weighted_and_explicit_k_bitwise(name):
    nv, edges = GRAPHS[name]
    deg = np.bincount(edges.reshape(-1), minlength=nv)
    for vw in (partition.split_slot_weight(deg, 8),
               np.linspace(0.5, 2.0, nv),
               np.full(nv, 1.5, np.float32)):
        np.testing.assert_array_equal(
            partition.two_phase_partition(nv, edges, 4, vertex_weight=vw),
            ref_part.two_phase_partition(nv, edges, 4, vertex_weight=vw))
    np.testing.assert_array_equal(
        partition.two_phase_partition(nv, edges, 4, k=11, seed=2),
        ref_part.two_phase_partition(nv, edges, 4, k=11, seed=2))


def test_atoms_meta_graph_and_balance_bitwise():
    nv, edges = GRAPHS["zipf2000"]
    atoms = partition.over_partition(nv, edges, 32, seed=3)
    np.testing.assert_array_equal(atoms,
                                  ref_part.over_partition(nv, edges, 32,
                                                          seed=3))
    got = partition.build_meta_graph(atoms, edges, 32)
    want = ref_part.build_meta_graph(atoms, edges, 32)
    assert list(got.edge_weight.items()) == [
        ((int(a), int(b)), w) for (a, b), w in want.edge_weight.items()]
    np.testing.assert_array_equal(got.vertex_weight, want.vertex_weight)
    for m in (3, 8):
        np.testing.assert_array_equal(partition.balance_meta_graph(got, m),
                                      ref_part.balance_meta_graph(want, m))


class _Model:
    """Prices a sweep by its launch count and widths; 0.5 us a ghost."""
    sync_cost_us = 0.5

    def predict_launches(self, launches):
        return float(sum(w * 1e-3 + 1.0 for w, _ in launches))


def test_cost_model_arbitration_and_its_parts_bitwise():
    nv, edges = GRAPHS["zipf2000"]
    deg = np.bincount(edges.reshape(-1), minlength=nv)
    for w_cap in (None, 8):
        np.testing.assert_array_equal(
            partition.two_phase_partition(nv, edges, 4, cost_model=_Model(),
                                          w_cap=w_cap),
            ref_part.two_phase_partition(nv, edges, 4, cost_model=_Model(),
                                         w_cap=w_cap))
    asg = ref_part.random_partition(nv, 4, seed=1)
    for w_cap in (None, 4, 16):
        assert partition.shard_bucket_launches(asg, deg, 4, w_cap) == \
            ref_part.shard_bucket_launches(asg, deg, 4, w_cap)
        assert partition.predicted_step_time(
            asg, deg, edges, 4, _Model(), w_cap) == \
            ref_part.predicted_step_time(asg, deg, edges, 4, _Model(), w_cap)
    np.testing.assert_array_equal(partition.ghost_rows(asg, edges, 4),
                                  ref_part.ghost_rows(asg, edges, 4))
    assert partition.cut_edges(asg, edges) == ref_part.cut_edges(asg, edges)
    np.testing.assert_array_equal(partition.split_slot_weight(deg, 16),
                                  ref_part.split_slot_weight(deg, 16))
    with pytest.raises(ValueError, match="power of two"):
        partition.split_slot_weight(deg, 6)


@pytest.mark.parametrize("m,seed", [(2, 0), (8, 3), (5, 11)])
def test_random_partition_bitwise(m, seed):
    np.testing.assert_array_equal(partition.random_partition(1000, m, seed),
                                  ref_part.random_partition(1000, m, seed))


def test_locality_beats_random_on_a_grid():
    nv, edges = GRAPHS["grid"]
    assert partition.cut_edges(partition.two_phase_partition(nv, edges, 4),
                               edges) < \
        partition.cut_edges(partition.random_partition(nv, 4), edges)


# ----------------------------------------------------------------------
# Forced shard shapes
# ----------------------------------------------------------------------

def _padded(nv, edges, md):
    return graph._build_ell_vectorized(nv, np.asarray(edges, np.int64), md)


def _same_ell(got, want):
    assert got.widths == tuple(want.widths)
    assert got.starts == tuple(want.starts)
    assert (got.n_rows, got.max_deg, got.pad_edge) == (
        want.n_rows, want.max_deg, want.pad_edge)
    for f in ("nbrs", "nbr_mask", "edge_ids", "is_src"):
        for a, b in zip(getattr(got, f), getattr(want, f)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    for f in ("perm", "inv_perm", "owner_of_vrow", "vrow_offset"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
    assert got.n_chunks_max == want.n_chunks_max


def test_forced_bucket_sizes_bitwise():
    nv, edges = GRAPHS["zipf2000"]
    md = int(np.bincount(edges.reshape(-1)).max())
    arrs = _padded(nv, edges, md)
    widths = ref_graph.default_bucket_widths(md)
    counts = np.bincount(ref_graph.bucket_index(widths,
                                                arrs[1].sum(axis=1)),
                         minlength=len(widths))
    sizes = (counts + np.arange(len(widths)) % 3).tolist()
    rows = graph.padded_slots(*arrs)
    _same_ell(graph.sliced_ell_from_slots(*rows, len(edges), widths, md,
                                          bucket_sizes=sizes, device="cpu"),
              ref_graph.build_sliced_ell(*arrs, pad_edge=len(edges),
                                         widths=widths, bucket_sizes=sizes))
    with pytest.raises(ValueError, match="bucket_sizes"):
        graph.sliced_ell_from_slots(*rows, len(edges), widths, md,
                                    bucket_sizes=[0] * len(widths),
                                    device="cpu")


@pytest.mark.parametrize("w_cap", [4, 16])
def test_forced_split_shapes_bitwise(w_cap):
    nv, edges = GRAPHS["zipf2000"]
    md = int(np.bincount(edges.reshape(-1)).max())
    arrs = _padded(nv, edges, md)
    vm = ref_graph.split_hub_rows(*arrs, len(edges), w_cap)
    widths = ref_graph.default_bucket_widths(w_cap)
    n_virtual = len(vm[4]) + 37
    counts = np.bincount(ref_graph.bucket_index(widths, vm[1].sum(axis=1)),
                         minlength=len(widths))
    counts[0] += 37
    sizes = (counts + 2).tolist()
    kw = dict(widths=widths, bucket_sizes=sizes, n_virtual=n_virtual)
    _same_ell(graph.split_ell_from_slots(*graph.padded_slots(*arrs),
                                         len(edges), w_cap, md,
                                         device="cpu", **kw),
              ref_graph.build_split_ell(*arrs, pad_edge=len(edges),
                                        w_cap=w_cap, **kw))
    with pytest.raises(ValueError, match="n_virtual"):
        graph.split_ell_from_slots(*graph.padded_slots(*arrs), len(edges),
                                   w_cap, md, n_virtual=len(vm[4]) - 1,
                                   device="cpu")


@pytest.mark.parametrize("w_cap", [None, 8])
def test_slot_lists_rebuild_the_padded_builder(w_cap):
    """``row_slots`` reads a graph's rows back in slot order, and
    ``sliced_ell_from_slots`` lays them out exactly as the reference's
    padded builder does, forced sizes included."""
    nv, edges = GRAPHS["zipf2000"]
    g = graph.DataGraph.from_edges(nv, edges, {}, w_cap=w_cap, device="cpu")
    cnt, flat = graph.row_slots(g.ell)
    pad = g.to_padded()
    np.testing.assert_array_equal(cnt, pad.nbr_mask.sum(1).numpy())
    md = g.max_deg
    widths = graph.default_bucket_widths(md)
    counts = np.bincount(graph.bucket_index(widths, cnt),
                         minlength=len(widths))
    sizes = (counts + 1).tolist()
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    got = graph.sliced_ell_from_slots(start, cnt, flat, g.n_edges, widths,
                                      md, bucket_sizes=sizes, device="cpu")
    want = ref_graph.build_sliced_ell(
        *(a.numpy() for a in pad), pad_edge=g.n_edges, widths=widths,
        bucket_sizes=sizes)
    _same_ell(got, want)


@pytest.mark.parametrize("w_cap", [None, 8])
def test_padded_builders_bitwise(w_cap):
    """The padded builders, wrappers over the slot-list builder, give
    the reference's padded builders' storage."""
    nv, edges = GRAPHS["zipf2000"]
    md = int(np.bincount(edges.reshape(-1)).max())
    arrs = _padded(nv, edges, md)
    if w_cap is None:
        _same_ell(graph.build_sliced_ell(*arrs, pad_edge=len(edges),
                                         device="cpu"),
                  ref_graph.build_sliced_ell(*arrs, pad_edge=len(edges)))
    else:
        _same_ell(graph.build_split_ell(*arrs, pad_edge=len(edges),
                                        w_cap=w_cap, device="cpu"),
                  ref_graph.build_split_ell(*arrs, pad_edge=len(edges),
                                            w_cap=w_cap))


def test_padded_slots_refuse_gapped_rows():
    """Real slots past a padding slot are refused, not dropped."""
    nbrs = np.array([[1, 0, 2], [0, 0, 0]], np.int32)
    mask = np.array([[True, False, True], [False, False, False]])
    eids = np.where(mask, [[0, 2, 1], [2, 2, 2]], 2).astype(np.int32)
    with pytest.raises(ValueError, match="prefix"):
        graph.build_sliced_ell(nbrs, mask, eids, np.zeros_like(mask), 2,
                               device="cpu")
    start, cnt, flat = graph.padded_slots(nbrs[:, :1], mask[:, :1],
                                          eids[:, :1], mask[:, :1])
    assert cnt.tolist() == [1, 0] and start.tolist() == [0, 1]
    assert [f.tolist() for f in flat] == [[1], [0], [True]]
