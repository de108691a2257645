"""Hub splitting on the port against the reference: the segmented sum
(B2), the split storage and the split dispatch.

* ``segment_combine`` (the reference's signature) and
  ``segment_sum_csr_plain`` (the CUDA kernel's plain version, over
  contiguous segments) are held bitwise to the reference's XLA
  scatter-add: both add a segment's rows in row order from +0.0.
* Split storage is held bitwise to the reference's through
  ``interop``: blocks, permutations, owner map, offsets and metadata.
  ``rows()``, ``row_activation`` and ``window_bucket`` equal the
  reference's.
* The four dispatch arms ({bucket, batch} x {kernel, dense}) are bitwise
  equal on a split graph for every engine; PageRank is within
  rtol = atol = 1e-5 of the reference's split run (ROADMAP C2: XLA fuses
  the reference's combine into an FMA), CC bitwise, counts included.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.apps import cc as ref_cc
from repro.apps import pagerank as ref_pagerank
from repro.core import graph as ref_graph
from repro.core.coloring import greedy_coloring as ref_greedy_coloring
from repro.core.engine_locking import conflict_winners as ref_conflict_winners
from repro.core.update import Consistency as RefConsistency
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro_torch import api, interop
from repro_torch.apps import cc, pagerank
from repro_torch.core import exec as port_exec
from repro_torch.core import graph
from repro_torch.core.engine_locking import (conflict_winners,
                                             conflict_winners_windowed)
from repro_torch.core.update import (Consistency, UpdateResult,
                                     aggregator_update)
from repro_torch.kernels.als_normal_eq import als_normal_eq
from repro_torch.kernels import segment_combine as sc
from repro_torch.kernels.segment_combine import (segment_combine,
                                                 segment_offsets,
                                                 segment_sum_csr,
                                                 segment_sum_csr_plain)
from torch_parity import reference_arrays


# ----------------------------------------------------------------------
# B2: the segmented sum
# ----------------------------------------------------------------------

def _segments(case):
    """``(y, seg_ids, n_rows)``: sorted ids, drawn from a seed."""
    rng = np.random.default_rng(len(case))
    n_rows, tail = 40, 0
    lengths = rng.integers(0, 5, n_rows)
    shape = (4,)
    if case == "f1":
        shape = (1,)
    elif case == "f32":
        shape = (32,)
    elif case == "dxd":
        shape = (5, 5)
    elif case == "sentinel":
        tail = 7
    elif case == "long":
        lengths[3] = 700             # longer than a block of 256 threads
    elif case == "empty":
        lengths[::2] = 0
    elif case == "f_odd":
        shape = (7,)
    seg = np.concatenate([np.repeat(np.arange(n_rows), lengths),
                          np.full(tail, n_rows)]).astype(np.int32)
    y = rng.normal(size=(len(seg),) + shape).astype(np.float32)
    if case == "negzero":
        y[rng.random(y.shape) < 0.5] = -0.0
        y[seg == 5] = -0.0           # a segment of -0.0 alone sums to +0.0
    return y, seg, n_rows


B2_CASES = ["f1", "f32", "dxd", "sentinel", "long", "empty", "negzero",
            "f_odd"]


@pytest.mark.parametrize("case", B2_CASES)
def test_segment_combine_matches_reference_bitwise(case):
    y, seg, n_rows = _segments(case)
    want = np.asarray(ref_ops.segment_combine(jnp.asarray(y),
                                              jnp.asarray(seg), n_rows))
    got = segment_combine(torch.from_numpy(y), torch.from_numpy(seg), n_rows)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    offsets = segment_offsets(torch.from_numpy(seg), n_rows)
    csr = segment_sum_csr_plain(torch.from_numpy(y), offsets)
    np.testing.assert_array_equal(csr.numpy().view(np.uint32),
                                  want.view(np.uint32))
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(segment_sum_csr(torch.from_numpy(y), offsets), csr)


def test_segment_combine_takes_ids_in_any_order():
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 12, 300).astype(np.int32)
    seg[rng.random(300) < 0.1] = 12                 # the sentinel
    y = rng.normal(size=(300, 3)).astype(np.float32)
    want = np.asarray(ref_ops.segment_combine(jnp.asarray(y),
                                              jnp.asarray(seg), 12))
    got = segment_combine(torch.from_numpy(y), torch.from_numpy(seg), 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_sum_csr_bf16_sums_in_float32():
    rng = np.random.default_rng(4)
    y = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32)).to(
        torch.bfloat16)
    offsets = torch.tensor([0, 10, 10, 64])
    got = segment_sum_csr(y, offsets)
    want = torch.stack([_serial(y[0:10]), torch.zeros(3),
                        _serial(y[10:64])]).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def _serial(rows):
    acc = torch.zeros(rows.shape[1:], dtype=torch.float32)
    for r in rows:
        acc = acc + r.float()
    return acc


@pytest.mark.parametrize("offsets,err", [
    (torch.zeros((2, 2), dtype=torch.int64), "1-D"),
    (torch.zeros(3, dtype=torch.float32), "int32 or int64"),
    (torch.zeros(0, dtype=torch.int64), "1-D"),
    (torch.zeros(3, dtype=torch.int64, device="meta"), "y is on cpu"),
])
def test_segment_sum_csr_rejects_bad_offsets(offsets, err):
    with pytest.raises(ValueError, match=err):
        segment_sum_csr(torch.zeros(4, 2), offsets)


@pytest.mark.parametrize("y,err", [
    (torch.tensor(1.0), "leading row axis"),
    (torch.zeros(4, 2, device="meta"), "runs on cuda or cpu"),
])
def test_segment_sum_csr_rejects_bad_rows(y, err):
    with pytest.raises(ValueError, match=err):
        segment_sum_csr(y, torch.zeros(3, dtype=torch.int64,
                                       device=y.device))


def test_segment_sum_csr_serial_is_the_plain_version():
    """The host's serial sum (the card checks' reference for a segment
    too long for the plain version's loop) is the plain version's adds:
    bitwise in float32 and bf16, -0.0 inputs, empty and clamped
    segments, a row of x with no rows."""
    rng = np.random.default_rng(21)
    y = torch.from_numpy(rng.normal(size=(20_000, 3)).astype(np.float32))
    y[::7] = -0.0
    for off in ([0, 0, 5, 16_000, 16_001, 19_990], [-3, 4, 2, 25_000]):
        off = torch.tensor(off)
        for t in (y, y.bfloat16()):
            view = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
            assert torch.equal(sc.segment_sum_csr_serial(t, off).view(view),
                               segment_sum_csr_plain(t, off).view(view))
    empty = torch.zeros((0, 3))
    off = torch.tensor([0, 0, 0])
    assert torch.equal(segment_sum_csr_plain(empty, off), torch.zeros(2, 3))
    assert torch.equal(sc.segment_sum_csr_serial(empty, off),
                       torch.zeros(2, 3))


# The card's launch plan: the B2 shapes of the main path (rows, x rows),
# a window chunk combine, MapReduce ALS's reduces, and small ones
_PLAN_SHAPES = [(2_097_152, 2_133_236), (1_130_479, 1_158_437),
                (32_768, 131_072), (17_770, 10_047_239),
                (48_019, 10_047_239), (1, 0), (3, 5), (10_007, 30_000)]


@pytest.mark.parametrize("off_bytes", [4, 8])
@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("feat", [1, 2, 7, 20, 32, 64, 129, 400])
def test_launch_plan_fits_the_card(feat, elt, off_bytes):
    """Every plan keeps a block's shared memory within Hopper's 227 KB
    and the SM's 228 KB, a tile within the build's pairs, and a
    persistent grid of at most ``blocks_per_sm`` a SM and no more blocks
    than tiles; a tile's x averages ``tile_bytes`` where the pairs
    allow."""
    geom = sc.DEFAULT_GEOMETRY
    for n_sm in (1, 132):
        for n_rows, n_src in _PLAN_SHAPES:
            p = sc.launch_plan(n_rows, n_src, feat, elt, off_bytes, n_sm)
            assert p.smem_bytes <= sc.SMEM_BLOCK
            assert p.blocks_per_sm * (p.smem_bytes
                                      + sc.SMEM_RESERVED) <= sc.SMEM_SM
            assert 1 <= p.blocks_per_sm <= geom.blocks_per_sm
            pairs = geom.threads * geom.pairs
            assert 1 <= p.tile_rows and p.tile_rows * p.slab <= pairs
            assert (p.n_slabs, p.slab) == (1, feat)
            assert p.n_items == -(-n_rows // p.tile_rows)
            assert 1 <= p.grid <= min(p.n_items, p.blocks_per_sm * n_sm)
            assert 2 <= p.n_stages <= geom.max_stages
            assert 16 <= p.stage_x <= geom.stage_bytes
            assert p.stage_x % 16 == 0
            stage = (p.smem_bytes - geom.barrier_bytes) // p.n_stages
            assert p.smem_bytes == geom.barrier_bytes + p.n_stages * stage
            off_area = stage - p.stage_x
            assert off_area % 16 == 0
            assert off_area >= (p.tile_rows + 1) * off_bytes + 30
            # the ring fills the block's share: one more stage would not fit
            share = min(sc.SMEM_BLOCK,
                        sc.SMEM_SM // p.blocks_per_sm - sc.SMEM_RESERVED)
            assert (p.n_stages == geom.max_stages
                    or p.smem_bytes + stage > share)
            # an average tile's x fits its stage, or the stage is the
            # largest that leaves room for MIN_STAGES
            x_tile = p.tile_rows * n_src * feat * elt // n_rows
            assert (x_tile <= p.stage_x or p.stage_x == geom.stage_bytes
                    or p.stage_x + off_area + 16
                    > (share - geom.barrier_bytes) // sc.MIN_STAGES)
            spread = -(-n_rows // (2 * geom.blocks_per_sm * n_sm))
            if n_src and p.tile_rows not in (1, pairs // feat, spread):
                assert geom.tile_bytes / 2 <= x_tile <= geom.tile_bytes
            assert p.tile_rows <= max(1, spread)


def test_launch_plan_stages_hold_whole_segments_of_alss_reduce():
    """MapReduce ALS's ``[Ne, 20]`` reduces (a user's ~209 rows are 16.7
    KB, a movie's ~565 are 45 KB): a tile of whole segments fits one
    stage, so each (segment, feature) pair is one uninterrupted chain,
    and the user job's tiles hold two segments, twice the chains; the
    owner combine's tiles are 2,048 single-row segments."""
    users = sc.launch_plan(48_019, 10_047_239, 20, 4, 8, 132)
    assert users.tile_rows == 2 and users.n_stages == 2
    assert users.stage_x >= 2 * 10_047_239 * 80 // 48_019
    movies = sc.launch_plan(17_770, 10_047_239, 20, 4, 8, 132)
    assert movies.tile_rows == 1
    assert movies.stage_x >= 10_047_239 * 80 // 17_770
    owner = sc.launch_plan(2_097_152, 2_133_236, 1, 4, 4, 132)
    assert owner.tile_rows == 2048 and owner.n_stages >= 4


def test_launch_plan_cuts_wide_rows_into_slabs():
    geom = sc.DEFAULT_GEOMETRY
    pairs = geom.threads * geom.pairs
    p = sc.launch_plan(7, 21, pairs * 2 + 1, 4, 8, 132)
    assert (p.tile_rows, p.slab, p.n_slabs, p.n_items) == (1, pairs, 3, 21)
    assert p.grid == 21
    # a tile's offsets too many for a block's share of two: one block an
    # SM, and stages small enough for two of them
    wide = sc.Geometry(pairs=48, tile_bytes=1 << 20)
    p = sc.launch_plan(1 << 22, 1 << 22, 1, 4, 8, 1, wide)
    assert (p.tile_rows, p.blocks_per_sm, p.n_stages) == (12_288, 1, 2)
    assert p.stage_x == ((232_448 - 256) // 2 - 98_352) // 16 * 16
    with pytest.raises(ValueError, match="shared memory"):
        sc.launch_plan(1 << 22, 1 << 22, 1, 4, 8, 1,
                       sc.Geometry(pairs=64, tile_bytes=1 << 20))
    with pytest.raises(ValueError, match="no launch"):
        sc.launch_plan(0, 100, 1, 4, 8, 132)


def test_default_geometry_is_the_sources():
    """The wrapper's ``DEFAULT_GEOMETRY`` is ``csrc/segment_combine.cu``'s
    ``SEG_*`` defaults (the card test checks the loaded build's)."""
    import re
    src = (Path(sc.__file__).parent / "csrc" / "segment_combine.cu"
           ).read_text()
    macros = dict(re.findall(r"#define SEG_(\w+) (\d+)", src))
    geom = sc.DEFAULT_GEOMETRY
    assert {k.lower(): int(v) for k, v in macros.items()
            if k.lower() in vars(geom)} == {
        k: v for k, v in vars(geom).items() if k != "barrier_bytes"}
    assert f"kBarrierBytes = {geom.barrier_bytes};" in src


def test_als_normal_eq_over_virtual_rows_plus_combine_equals_unsplit():
    """B3 over ``w_cap``-wide chunks of each row, then B2 per owner,
    equals B3 over whole rows (A and b are linear in the slots), within
    rtol = atol = 1e-4 of the reference's plain einsums (the mirror of
    tests/test_kernels.py's split test)."""
    rng = np.random.default_rng(11)
    nv, deg, rows, d, wc = 9, 13, 40, 4, 4
    nbrs = rng.integers(0, rows, (nv, deg)).astype(np.int32)
    mask = rng.random((nv, deg)) < 0.7
    rat = rng.normal(size=(nv, deg)).astype(np.float32)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    ar, br = ref_kernels.als_normal_eq_ref(jnp.asarray(nbrs),
                                           jnp.asarray(mask),
                                           jnp.asarray(rat), jnp.asarray(x))
    s = -(-deg // wc)
    pad = s * wc - deg

    def chunk(a, fill):
        a = np.concatenate([a, np.full((nv, pad), fill, a.dtype)], axis=1)
        return torch.from_numpy(a.reshape(nv * s, wc))

    a_v, b_v = als_normal_eq(chunk(nbrs, 0), chunk(mask, False),
                             chunk(rat, 0.0), torch.from_numpy(x))
    offsets = torch.arange(nv + 1) * s
    a_c = segment_sum_csr(a_v.contiguous(), offsets)
    b_c = segment_sum_csr(b_v.contiguous(), offsets)
    np.testing.assert_allclose(a_c.numpy(), np.asarray(ar), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(b_c.numpy(), np.asarray(br), rtol=1e-4,
                               atol=1e-4)
    a_w, b_w = als_normal_eq(torch.from_numpy(nbrs), torch.from_numpy(mask),
                             torch.from_numpy(rat), torch.from_numpy(x))
    np.testing.assert_allclose(a_c.numpy(), a_w.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(b_c.numpy(), b_w.numpy(), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------------
# Split storage
# ----------------------------------------------------------------------

SPLIT_GRAPHS = {
    "zipf400_w8": (400, lambda: ref_graph.zipf_edges(400, alpha=2.0,
                                                     max_deg=48, seed=6),
                   {"w_cap": 8}),
    "zipf400_default": (400, lambda: ref_graph.zipf_edges(
        400, alpha=2.0, max_deg=48, seed=6), {"hub_split": True}),
    "zipf2000_w16": (2000, lambda: ref_graph.zipf_edges(
        2000, alpha=2.0, max_deg=64, seed=1), {"w_cap": 16}),
    "zipf2000_w4": (2000, lambda: ref_graph.zipf_edges(
        2000, alpha=2.0, max_deg=64, seed=1), {"w_cap": 4}),
}


def _both_split(name, edge_locality=True):
    n, edges_fn, kw = SPLIT_GRAPHS[name]
    edges = edges_fn()
    vdata = {"x": np.arange(n, dtype=np.float32)}
    edata = {"w": np.random.default_rng(n).random(len(edges)).astype(
        np.float32)}
    ref = ref_graph.DataGraph.from_edges(n, edges, vdata, edata,
                                         edge_locality=edge_locality, **kw)
    port = graph.DataGraph.from_edges(n, edges, vdata, edata,
                                      edge_locality=edge_locality,
                                      device="cpu", **kw)
    return n, edges, ref, port


@pytest.mark.parametrize("edge_locality", [True, False])
@pytest.mark.parametrize("name", sorted(SPLIT_GRAPHS))
def test_split_storage_bitwise(name, edge_locality):
    _, _, ref, port = _both_split(name, edge_locality)
    assert port.ell.is_split and ref.ell.is_split
    want, want_meta = reference_arrays(ref)
    got, got_meta = interop.graph_to_arrays(port)
    assert got_meta == want_meta
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port.ell.n_virtual == ref.ell.n_virtual
    assert port.ell.scope_widths == ref.ell.scope_widths


@pytest.mark.parametrize("name", sorted(SPLIT_GRAPHS))
def test_split_graph_crosses_interop_both_ways(name):
    _, _, ref, _ = _both_split(name)
    arrays, meta = reference_arrays(ref)
    port = interop.graph_from_arrays(arrays, meta, device="cpu")
    assert port.ell.w_cap == ref.ell.w_cap
    assert port.ell.n_chunks_max == ref.ell.n_chunks_max
    again, again_meta = interop.graph_to_arrays(port)
    assert again_meta == meta
    for k in arrays:
        np.testing.assert_array_equal(again[k], arrays[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(SPLIT_GRAPHS))
def test_split_rows_round_trip_to_the_unsplit_rows(name):
    """``rows()`` at ``max_deg`` reassembles each hub from its chunks:
    bitwise the unsplit padded row, and the reference's split rows at
    every scope width."""
    n, edges, ref, port = _both_split(name, edge_locality=False)
    unsplit = graph.DataGraph.from_edges(n, edges, {"x": np.zeros(n)},
                                         edge_locality=False, device="cpu")
    for a, b in zip(port.to_padded(), unsplit.to_padded()):
        assert torch.equal(a, b)
    ids = np.arange(n, dtype=np.int32)
    for w in port.ell.scope_widths:
        got = port.ell.rows(torch.from_numpy(ids), width=w)
        want = ref.ell.rows(jnp.asarray(ids), width=w)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", sorted(SPLIT_GRAPHS))
def test_split_row_activation_and_window_bucket_match_reference(name):
    n, _, ref, port = _both_split(name)
    rng = np.random.default_rng(7)
    deg = port.degree.numpy()
    hubs = np.nonzero(deg > port.ell.w_cap)[0]
    assert len(hubs)
    for size in (1, 3, 16, 64):
        for trial in range(3):
            ids = rng.choice(n, size=size, replace=False).astype(np.int32)
            if trial == 0:
                ids[0] = hubs[rng.integers(len(hubs))]
            sel = rng.random(size) < 0.7
            t_ids, t_sel = torch.from_numpy(ids), torch.from_numpy(sel)
            j_ids, j_sel = jnp.asarray(ids), jnp.asarray(sel)
            assert port.ell.window_bucket(t_ids, t_sel) == int(
                ref.ell.window_bucket(j_ids, j_sel)), (size, trial)
            np.testing.assert_array_equal(
                port.ell.row_activation(t_ids, t_sel).numpy(),
                np.asarray(ref.ell.row_activation(j_ids, j_sel)))


def test_split_flat_and_bucket_gathers_match(monkeypatch):
    """The split rows through ``_bucket_rows`` (a batch above
    ``FLAT_GATHER_SLOTS``) equal those through ``_flat_rows``."""
    n, _, _, port = _both_split("zipf2000_w16")
    ids = torch.arange(n)
    flat = [port.ell.rows(ids, width=w) for w in port.ell.scope_widths]
    monkeypatch.setattr(graph, "FLAT_GATHER_SLOTS", 0)
    for w, want in zip(port.ell.scope_widths, flat):
        for a, b in zip(port.ell.rows(ids, width=w), want):
            assert torch.equal(a, b), w


def test_split_caps_the_widest_bucket():
    """With splitting on, the widest stored block is ``w_cap`` whatever
    the skew, and the slot count is at most the unsplit layout's."""
    edges = ref_graph.zipf_edges(2000, alpha=2.0, max_deg=64, seed=1)
    vd = {"x": np.zeros(2000, np.float32)}
    g0 = graph.DataGraph.from_edges(2000, edges, vd, device="cpu")
    gs = graph.DataGraph.from_edges(2000, edges, vd, w_cap=16, device="cpu")
    assert g0.ell.widths[-1] > 16 and gs.ell.widths[-1] == 16
    assert gs.ell.padded_slots <= g0.ell.padded_slots
    # a graph whose rows all fit w_cap stays unsplit
    fits = graph.DataGraph.from_edges(2000, edges, vd, w_cap=64,
                                      device="cpu")
    assert not fits.ell.is_split and fits.ell.n_virtual == 2000


def test_default_w_cap_matches_reference():
    rng = np.random.default_rng(0)
    for deg in (np.zeros(0), np.ones(10), rng.zipf(2.0, 1000),
                rng.integers(0, 300, 500), np.full(50, 7)):
        assert graph.default_w_cap(deg) == ref_graph.default_w_cap(deg)


# (kwargs, message) of the illegal values and combinations
ILLEGAL = [
    ({"w_cap": 6}, "power of two"),
    ({"w_cap": 1}, "power of two"),
    ({"w_cap": 0}, "power of two"),
    ({"w_cap": 8.0}, "power of two"),
    ({"w_cap": 8, "bucket_widths": (2, 8)}, "bucket_widths"),
    ({"hub_split": True, "bucket_widths": (2, 8)}, "bucket_widths"),
    ({"width_policy": "measured", "hub_split": True}, "chooses the bucket"),
    ({"width_policy": "measured", "w_cap": 8}, "chooses the bucket"),
    ({"width_policy": "bogus"}, "unknown width_policy"),
    ({"slack": 2, "hub_split": True}, "incompatible"),
    ({"slack": -1}, "non-negative"),
]


@pytest.mark.parametrize("kwargs,message", ILLEGAL)
def test_split_options_raise_the_references_value_errors(kwargs, message):
    edges = ref_graph.zipf_edges(100, alpha=2.0, max_deg=32, seed=2)
    vd = {"x": np.zeros(100, np.float32)}
    with pytest.raises(ValueError, match=message):
        ref_graph.DataGraph.from_edges(100, edges, vd, **kwargs)
    with pytest.raises(ValueError, match=message):
        graph.DataGraph.from_edges(100, edges, vd, device="cpu", **kwargs)


# ----------------------------------------------------------------------
# Split dispatch
# ----------------------------------------------------------------------

def _zipf_split(nv=150, max_deg=48, seed=9, w_cap=8):
    edges = ref_graph.zipf_edges(nv, alpha=2.0, max_deg=max_deg, seed=seed)
    ref = ref_pagerank.make_graph(edges, nv, w_cap=w_cap)
    port = interop.graph_from_arrays(*reference_arrays(ref), device="cpu")
    assert port.ell.is_split and port.ell.n_buckets >= 3
    return edges, ref, port


PR_MODES = {
    "chromatic": ({}, {"max_supersteps": 200}),
    "bsp": ({}, {"num_supersteps": 8}),
    "priority": ({"k_select": 16}, {"num_supersteps": 120}),
    "locking": ({"max_pending": 16}, {"num_supersteps": 120}),
}


@pytest.fixture(scope="module")
def split_pr():
    edges, ref, port = _zipf_split()
    upd = ref_pagerank.make_update(1e-6)
    runs = {m: ref_api.run(ref, upd, scheduler=m, dispatch="bucket", **o, **r)
            for m, (o, r) in PR_MODES.items()}
    return dict(edges=edges, ref=ref, port=port, runs=runs)


@pytest.mark.parametrize("mode", list(PR_MODES))
def test_split_pagerank_dispatch_paths_bitwise(split_pr, mode):
    """{batch, bucket} x {kernel, dense} on a graph split at w_cap = 8:
    four bitwise-equal runs per engine (the mirror of
    tests/test_dispatch.py's split invariant), within rtol = atol = 1e-5
    of the reference's split run.  The chromatic run converges at
    eps = 1e-6, so rounding one ulp apart may end it a superstep apart
    from the reference's."""
    opts, run_args = PR_MODES[mode]
    upd = pagerank.make_update(1e-6)
    outs = {(d, k): api.run(split_pr["port"], upd, scheduler=mode,
                            dispatch=d, use_kernel=k, device="cpu",
                            **opts, **run_args)
            for d in ("bucket", "batch") for k in (True, False)}
    base = outs["bucket", True]
    for key, st in outs.items():
        assert torch.equal(st.vertex_data["rank"], base.vertex_data["rank"]), \
            key
        assert torch.equal(st.state.active, base.state.active), key
        assert (st.superstep, st.n_updates) == (base.superstep,
                                                base.n_updates), key
    want = split_pr["runs"][mode]
    assert abs(base.superstep - int(want.superstep)) <= (
        1 if mode == "chromatic" else 0)
    np.testing.assert_allclose(base.vertex_data["rank"].numpy(),
                               np.asarray(want.vertex_data["rank"]),
                               rtol=1e-5, atol=1e-5)


def test_split_pagerank_through_build_matches_from_edges(split_pr):
    """``pagerank.build(w_cap=)`` builds the reference's split graph."""
    g, _, _ = pagerank.build(split_pr["edges"], 150, w_cap=8, device="cpu")
    want, want_meta = reference_arrays(split_pr["ref"])
    got, got_meta = interop.graph_to_arrays(g)
    assert got_meta == want_meta
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_auto_threshold_on_split_graph(split_pr, monkeypatch):
    """On a split graph the engines feed ``ell.widths[-1]`` (= w_cap) to
    ``choose_dispatch``: a k = 8 window launches window-shaped, a k = Nv
    one every bucket's rows (the mirror of tests/test_dispatch.py)."""
    g = split_pr["port"]
    ell = g.ell
    assert ell.widths[-1] == 8 < ell.max_deg
    for b, want in ((8, "batch"), (g.n_vertices, "bucket"), (32, "batch")):
        assert port_exec.choose_dispatch("auto", b, ell.widths[-1],
                                         ell.padded_slots) == want
    assert port_exec.choose_dispatch("auto", 32, ell.max_deg,
                                     ell.padded_slots) == "bucket"
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


def test_split_window_combines_hub_chunks(split_pr, monkeypatch):
    """A window holding a hub runs at ``[B*s, w_cap]`` chunk pseudo-rows
    and combines them with ``segment_sum_csr``: the combine is called
    with ``s`` rows a segment."""
    g = split_pr["port"]
    seen = []
    real = port_exec.segment_sum_csr

    def spy(y, offsets):
        seen.append((y.shape[0], offsets.shape[0] - 1))
        return real(y, offsets)
    monkeypatch.setattr(port_exec, "segment_sum_csr", spy)
    hub = int(torch.argmax(g.degree))
    active = np.zeros(g.n_vertices, bool)
    active[hub] = True
    api.run(g, pagerank.make_update(1e-6), scheduler="priority", k_select=4,
            dispatch="batch", active=active, num_supersteps=1, device="cpu")
    s = g.ell.snap_width(int(g.degree[hub])) // g.ell.w_cap
    assert seen == [(4 * s, 4)]


def _normalized_weights(nv, edges):
    deg = np.maximum(np.bincount(edges.reshape(-1), minlength=nv), 1)
    return (1.0 / np.sqrt(deg[edges[:, 0]] * deg[edges[:, 1]])).astype(
        np.float32)


@pytest.mark.parametrize("mode", list(PR_MODES))
def test_edge_locality_composes_with_split(mode):
    """The bucket-major edge renumbering walks the virtual-row blocks of
    a split graph and is bitwise inert for every engine (the mirror of
    tests/test_dispatch.py)."""
    nv = 100
    edges = ref_graph.zipf_edges(nv, alpha=2.0, max_deg=32, seed=5)
    w = _normalized_weights(nv, edges)
    colors = ref_greedy_coloring(nv, edges)
    upd = pagerank.make_update(1e-6)
    opts, run_args = PR_MODES[mode]

    def build(locality):
        g = graph.DataGraph.from_edges(
            nv, edges, {"rank": np.ones(nv, np.float32)}, {"w": w},
            w_cap=8, edge_locality=locality, device="cpu")
        assert g.ell.is_split
        return g.with_colors(colors)

    g_on, g_off = build(True), build(False)
    assert not np.array_equal(g_on.edge_perm, g_off.edge_perm)
    for dispatch in ("batch", "bucket"):
        on = api.run(g_on, upd, scheduler=mode, dispatch=dispatch,
                     device="cpu", **opts, **run_args)
        off = api.run(g_off, upd, scheduler=mode, dispatch=dispatch,
                      device="cpu", **opts, **run_args)
        assert torch.equal(on.vertex_data["rank"], off.vertex_data["rank"])
        assert on.n_updates == off.n_updates
        np.testing.assert_array_equal(
            on.edge_data["w"][:-1].numpy()[g_on.edge_inv_perm],
            off.edge_data["w"][:-1].numpy())


CC_CASES = {
    "chromatic": ("chromatic", {}),
    "bsp": ("bsp", {}),
    "priority": ("priority", {"k_select": 16}),
    "locking": ("locking", {"max_pending": 16}),
}


@pytest.fixture(scope="module")
def split_cc():
    n = 150
    edges = ref_graph.zipf_edges(n, alpha=2.0, max_deg=48, seed=9)
    g, upd, _ = ref_cc.build(edges, n)
    gs = ref_graph.DataGraph.from_edges(
        n, edges, {"label": np.arange(n, dtype=np.int32)},
        w_cap=8).with_colors(np.asarray(g.colors))
    runs = {name: ref_api.run(gs, upd, scheduler=s, **o)
            for name, (s, o) in CC_CASES.items()}
    return dict(n=n, edges=edges, ref=gs, runs=runs,
                port=interop.graph_from_arrays(*reference_arrays(gs),
                                               device="cpu"),
                unsplit=interop.graph_from_arrays(*reference_arrays(g),
                                                  device="cpu"))


@pytest.mark.parametrize("name", list(CC_CASES))
def test_split_cc_matches_reference_and_unsplit_bitwise(split_cc, name):
    """CC on a split graph: labels, supersteps and updates equal the
    reference's split run, the port's unsplit run and union-find, under
    both launch shapes."""
    sched, opts = CC_CASES[name]
    want = split_cc["runs"][name]
    assert split_cc["port"].ell.is_split
    unsplit = api.run(split_cc["unsplit"], cc.make_update(), scheduler=sched,
                      device="cpu", **opts)
    for dispatch in ("bucket", "batch"):
        got = api.run(split_cc["port"], cc.make_update(), scheduler=sched,
                      dispatch=dispatch, device="cpu", **opts)
        np.testing.assert_array_equal(got.vertex_data["label"].numpy(),
                                      np.asarray(want.vertex_data["label"]))
        assert (got.superstep, got.n_updates) == (int(want.superstep),
                                                  int(want.n_updates))
        assert torch.equal(got.vertex_data["label"],
                           unsplit.vertex_data["label"])
    np.testing.assert_array_equal(
        got.vertex_data["label"].numpy(),
        cc.reference_components(split_cc["edges"], split_cc["n"]))


def test_split_claim_pass_matches_reference(split_cc):
    """The locking engine's claim pass reads ``struct_rows``: on a split
    graph its winners equal the reference's, at ``max_deg`` and at the
    window's snapped width."""
    g, ref = split_cc["port"], split_cc["ref"]
    rng = np.random.default_rng(0)
    for trial in range(6):
        ids = rng.choice(split_cc["n"], size=16, replace=False).astype(
            np.int32)
        sel = rng.random(16) < 0.8
        t_ids, t_sel = torch.from_numpy(ids), torch.from_numpy(sel)
        for cons in ("FULL", "EDGE"):
            full = conflict_winners(g, t_ids, t_sel, Consistency[cons])
            win = conflict_winners_windowed(g, t_ids, t_sel,
                                            Consistency[cons])
            want = ref_conflict_winners(ref, jnp.asarray(ids),
                                        jnp.asarray(sel),
                                        RefConsistency[cons])
            assert torch.equal(full, win), (trial, cons)
            np.testing.assert_array_equal(full.numpy(), np.asarray(want))


def _integer_sum_update():
    """An aggregator over integer-valued features: the sum of the
    neighbours' ``val`` (small integers, so every float32 sum is
    exact, in any grouping)."""
    def combine(scope, y):
        return UpdateResult(v_data={"val": scope.v_data["val"],
                                    "out": y[:, 0]})
    return aggregator_update(lambda vd: vd["val"][..., None],
                             lambda scope: torch.ones_like(
                                 scope.nbr_mask, dtype=torch.float32),
                             combine, Consistency.EDGE, name="intsum")


@pytest.mark.parametrize("mode", list(PR_MODES))
def test_integer_features_split_equals_unsplit(mode):
    nv = 300
    edges = ref_graph.zipf_edges(nv, alpha=2.0, max_deg=64, seed=3)
    vals = np.random.default_rng(1).integers(-50, 50, nv).astype(np.float32)
    colors = ref_greedy_coloring(nv, edges)
    vd = {"val": vals, "out": np.zeros(nv, np.float32)}
    graphs = [graph.DataGraph.from_edges(nv, edges, vd, device="cpu",
                                         **kw).with_colors(colors)
              for kw in ({}, {"w_cap": 4})]
    assert graphs[1].ell.is_split and graphs[1].ell.n_chunks_max > 2
    opts = PR_MODES[mode][0]
    outs = [api.run(g, _integer_sum_update(), scheduler=mode, dispatch=d,
                    use_kernel=k, num_supersteps=2, device="cpu", **opts)
            for g in graphs for d in ("bucket", "batch")
            for k in (True, False)]
    for st in outs[1:]:
        assert torch.equal(st.vertex_data["out"], outs[0].vertex_data["out"])
    deg_sum = np.zeros(nv, np.float64)
    np.add.at(deg_sum, edges[:, 0], vals[edges[:, 1]])
    np.add.at(deg_sum, edges[:, 1], vals[edges[:, 0]])
    if mode in ("chromatic", "bsp"):     # every vertex ran
        np.testing.assert_array_equal(outs[0].vertex_data["out"].numpy(),
                                      deg_sum.astype(np.float32))
