"""The port's CUDA kernels and its GPU runs, on a card.

This file imports no JAX, so it runs on a GPU host that has only the
port installed:

    python -m pytest -q tests/test_torch_cuda.py

Without a CUDA device every test skips.  Each kernel is held to its
plain PyTorch version on the same card (bitwise in float32, 2e-2 in
bfloat16), and PageRank on the GPU to the same PageRank on the CPU,
bitwise: the kernels' products and adds are unfused, as the CPU's eager
slot loops are.  ALS on the GPU equals ALS on the CPU bitwise in its
normal equations; its factors pass through cuSOLVER's LU on the card and
LAPACK's on the CPU, so they are held to rtol = 1e-4, atol = 1e-5, and
so are its color-major plan and its routed phases on the card.
The window-attention kernel is held to its plain version within 1e-5
absolute: both compute in float32, but the kernel's online softmax sums
in another order, and with a bf16 cache it takes q and p as two bf16
terms each on the tensor cores (~2e-6 from float32).  Decoding on the
GPU is held to decoding on the CPU within 1e-4 (float32 parameters, TF32 off): cuBLAS and the CPU's BLAS
sum the projections in other orders.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.apps import als, pagerank
from repro_torch.core.coloring import greedy_coloring
from repro_torch.core.exec import build_color_batches
from repro_torch.core.graph import DataGraph, zipf_edges
from repro_torch.core.update import gather_scopes
from repro_torch.kernels import als_normal_eq as als_port
from repro_torch.kernels import ell_spmv as port
from repro_torch.kernels import window_attention as wa
from repro_torch.kernels.ref import (decode_window_attention_partial_ref,
                                     decode_window_attention_ref)
from repro_torch.profile import tracing

SHAPES = [                       # (nv, deg, rows, feat)
    (1, 1, 1, 1),
    (7, 3, 11, 5),
    (128, 8, 128, 32),
    (200, 7, 300, 20),
    (513, 16, 300, 129),
    (200, 8, 300, 1),
    (64, 32, 100, 1),
    (300, 2, 300, 1),
    (1000, 62, 3000, 1),         # a last bucket's non-power-of-two width
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _inputs(nv, deg, rows, feat, dtype, device):
    rng = np.random.default_rng(nv * 7 + deg)
    nbrs = torch.from_numpy(rng.integers(0, rows, (nv, deg)).astype(np.int32))
    w = torch.from_numpy(rng.random((nv, deg)) * (rng.random((nv, deg)) < 0.7))
    x = torch.from_numpy(rng.normal(size=(rows, feat)))
    mask = torch.from_numpy(rng.random(nv) < 0.8)
    return (nbrs.to(device), w.to(dtype).to(device), x.to(dtype).to(device),
            mask.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nv,deg,rows,feat", SHAPES)
def test_kernel_matches_plain_version_on_card(cuda, nv, deg, rows, feat,
                                              dtype):
    args = _inputs(nv, deg, rows, feat, dtype, cuda)
    want = port.ell_spmv_plain(*args)
    before = port.ell_spmv.launches
    got = port.ell_spmv(*args)
    torch.cuda.synchronize()
    assert port.ell_spmv.launches == before + 1
    assert got.dtype == dtype and got.shape == (nv, feat)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
    # the same call on the CPU runs the plain version: bitwise in float32
    cpu = port.ell_spmv(*(a.cpu() for a in args))
    if dtype == torch.float32:
        assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
def test_entry_points_share_the_launch(cuda):
    nbrs, w, x, mask = _inputs(300, 8, 400, 1, torch.float32, cuda)
    before = port.ell_spmv.launches
    y = port.ell_spmv_bucketed([nbrs[:100], nbrs[100:]], [w[:100], w[100:]],
                               x, [mask[:100], mask[100:]])
    assert torch.equal(y, port.ell_spmv(nbrs, w, x, mask))
    vals = x[nbrs.long()]                               # [Nv, W, 1]
    assert torch.equal(port.ell_fold(w, vals, mask), y)
    assert torch.equal(port.ell_spmv_batched(nbrs, w, x, mask), y)
    # one launch each: the bucketed call's two buckets share one
    assert port.ell_spmv.launches == before + 4


def _bucket_set(seed, feat, dtype, device):
    """A random table: 1-8 buckets, some empty, widths 0-1,024 (odd ones
    included), out-of-range indices, bool, float or no row masks."""
    rng = np.random.default_rng(seed)
    rows = 500
    x = torch.from_numpy(rng.normal(size=(rows, feat))).to(dtype).to(device)
    buckets = []
    for b in range(int(rng.integers(1, 9))):
        nv = int(rng.choice([0, 1, 7, 33, 300, 1000]))
        width = int(rng.choice([0, 1, 2, 3, 4, 8, 13, 16, 62, 64, 128, 256,
                                257, 667, 1024]))
        nbrs = torch.from_numpy(
            rng.integers(-2, rows + 2, (nv, width)).astype(np.int32))
        w = torch.from_numpy(rng.random((nv, width))
                             * (rng.random((nv, width)) < 0.7)).to(dtype)
        mask = [None, torch.from_numpy(rng.random(nv) < 0.8),
                torch.from_numpy(rng.random(nv)).to(dtype)][b % 3]
        buckets.append((nbrs.to(device), w.to(device),
                        None if mask is None else mask.to(device)))
    return buckets, x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("feat", [1, 32])
@pytest.mark.parametrize("seed", range(6))
def test_table_launch_matches_plain_version(cuda, seed, feat, dtype):
    buckets, x = _bucket_set(seed, feat, dtype, cuda)
    masks = [m for _, _, m in buckets]
    want = torch.cat([port.ell_spmv_plain(nb, w, x, m)
                      for nb, w, m in buckets])
    before = port.ell_spmv.launches
    got = port.ell_spmv_bucketed([nb for nb, _, _ in buckets],
                                 [w for _, w, _ in buckets], x, masks)
    torch.cuda.synchronize()
    assert port.ell_spmv.launches == before + (1 if got.numel() else 0)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.cuda
def test_wide_rows_in_chunks_match_plain_version(cuda):
    # rows wider than the slots a block gathers in one pass
    nbrs, w, x, mask = _inputs(9, port.TILE + 905, 3000, 1, torch.float32,
                               cuda)
    assert torch.equal(port.ell_spmv(nbrs, w, x, mask),
                       port.ell_spmv_plain(nbrs, w, x, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [1, 32])
def test_masked_row_reading_inf_is_nan(cuda, feat):
    nbrs, w, x, mask = _inputs(64, 4, 100, feat, torch.float32, cuda)
    x[7] = float("inf")
    nbrs[:8] = 7
    nbrs[8:16] = 1000                  # out of range: clamps to row 99
    x[99] = float("inf")
    mask[:16] = False
    got = port.ell_spmv(nbrs, w, x, mask)
    want = port.ell_spmv_plain(nbrs, w, x, mask)
    torch.cuda.synchronize()
    assert torch.isnan(got[:16]).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.cuda
def test_table_raises_above_its_bucket_limit(cuda):
    # above its bucket limit the table no longer raises: a call of n
    # non-empty buckets makes ceil(n / MAX_BUCKETS) launches, each writing
    # its rows of the one output, bitwise the plain version's
    nbrs, w, x, mask = _inputs(300, 8, 400, 1, torch.float32, cuda)
    vals = x[nbrs.long()]                               # [Nv, W, 1]
    for n in (16, 17, 20, 33):
        cut = np.linspace(0, 300, n + 1).astype(int)
        blocks = [slice(a, b) for a, b in zip(cut, cut[1:])]
        blocks += [slice(0, 0)] * 3                     # empty ones ride along
        want = torch.cat([port.ell_spmv_plain(nbrs[s], w[s], x, mask[s])
                          for s in blocks])
        before = port.ell_spmv.launches
        got = port.ell_spmv_bucketed([nbrs[s] for s in blocks],
                                     [w[s] for s in blocks], x,
                                     [mask[s] for s in blocks])
        fold = port.ell_fold_bucketed([w[s] for s in blocks],
                                      [vals[s] for s in blocks],
                                      [mask[s] for s in blocks])
        torch.cuda.synchronize()
        launches = -(-n // port.MAX_BUCKETS)
        assert port.ell_spmv.launches == before + 2 * launches
        assert torch.equal(got, want) and torch.equal(fold, want)


@pytest.mark.cuda
def test_bucketed_calls_count_one_launch(cuda):
    nbrs, w, x, mask = _inputs(300, 8, 400, 1, torch.float32, cuda)
    cut = [0, 50, 50, 120, 300]                 # one empty bucket
    blocks = [slice(a, b) for a, b in zip(cut, cut[1:])]
    before = port.ell_spmv.launches
    y = port.ell_spmv_bucketed([nbrs[s] for s in blocks],
                               [w[s] for s in blocks], x,
                               [mask[s] for s in blocks])
    assert port.ell_spmv.launches == before + 1
    vals = x[nbrs.long()]                               # [Nv, W, 1]
    yf = port.ell_fold_bucketed([w[s] for s in blocks],
                                [vals[s] for s in blocks],
                                [mask[s] for s in blocks])
    assert port.ell_spmv.launches == before + 2
    assert torch.equal(y, port.ell_spmv_plain(nbrs, w, x, mask))
    assert torch.equal(yf, y)


@pytest.mark.cuda
def test_wrapper_raises_on_cuda_arguments_it_does_not_take(cuda):
    nbrs, w, x, mask = _inputs(10, 4, 20, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="dtype"):
        port.ell_spmv(nbrs, w, x.double(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        port.ell_spmv(nbrs, w, torch.cat([x, x], 1)[:, ::2], mask)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [True, False])
def test_gpu_pagerank_equals_cpu_pagerank_bitwise(cuda, use_kernel):
    edges = zipf_edges(2000, alpha=2.0, max_deg=64, seed=1)
    g, upd, syncs = pagerank.build(edges, 2000, eps=1e-4, device="cpu")
    cpu = api.run(g, upd, syncs=syncs, device="cpu")
    before = port.ell_spmv.launches
    gpu = api.run(g, upd, syncs=syncs, device=cuda, use_kernel=use_kernel)
    assert port.ell_spmv.launches > before
    assert torch.equal(gpu.vertex_data["rank"].cpu(), cpu.vertex_data["rank"])
    assert (gpu.superstep, gpu.n_updates) == (cpu.superstep, cpu.n_updates)
    assert gpu.globals["total_rank"].item() == cpu.globals["total_rank"].item()


@pytest.mark.cuda
def test_gpu_chromatic_gather_makes_no_host_sync(cuda):
    """On the color-major phase plan a phase's scope gather only indexes
    vertex and edge data through its groups' blocks: the program's
    ``gather`` spans count no device-to-host synchronization, and no
    phase falls back to the routed path."""
    edges = zipf_edges(2000, alpha=2.0, seed=1)
    g, upd, syncs = pagerank.build(edges, 2000, eps=1e-4, device=cuda)
    with tracing(cuda) as rec:
        res = api.run(g, upd, syncs=syncs, device=cuda)
    s = rec.summary()
    assert res.superstep > 0 and not res.active_any
    assert s["spans"]["gather"]["calls"] > 0
    assert s["spans"]["gather"]["host_syncs"] == 0
    assert s["counters"].get("phases.fallback", 0) == 0
    assert s["counters"]["host_syncs"] > 0     # the counting is on


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [True, False])
def test_gpu_pagerank_over_20_buckets_equals_cpu_pagerank(cuda, use_kernel):
    # more buckets than one launch takes: every sweep and fold is two
    # launches on the card, and the run stays bitwise the CPU's
    n = 2000
    edges = zipf_edges(n, alpha=2.0, max_deg=20, seed=1)
    g = DataGraph.from_edges(
        n, edges, vertex_data={"rank": np.ones(n, np.float32)},
        edge_data={"w": pagerank.edge_weights(edges, n)},
        edge_locality=False, bucket_widths=range(1, 21), device="cpu")
    g = g.with_colors(greedy_coloring(n, edges))
    assert g.ell.n_buckets == 20
    upd = pagerank.make_update(1e-4)
    syncs = (pagerank.second_most_popular_sync(), pagerank.total_rank_sync())
    cpu = api.run(g, upd, syncs=syncs, device="cpu")
    before = port.ell_spmv.launches
    gpu = api.run(g, upd, syncs=syncs, device=cuda, use_kernel=use_kernel)
    assert port.ell_spmv.launches > before
    assert torch.equal(gpu.vertex_data["rank"].cpu(), cpu.vertex_data["rank"])
    assert (gpu.superstep, gpu.n_updates) == (cpu.superstep, cpu.n_updates)
    assert gpu.globals["total_rank"].item() == cpu.globals["total_rank"].item()


ALS_SHAPES = [                   # (nv, deg, rows, d)
    (1, 1, 2, 4),
    (50, 5, 60, 4),
    (130, 9, 100, 5),
    (257, 40, 300, 16),
    (200, 70, 300, 20),
    (64, 33, 100, 64),
    (300, 1, 50, 20),
    (5, 0, 3, 4),                # no slots: A and b are 0
    (40, 31, 80, 1),
]


def _als_inputs(nv, deg, rows, d, density, device):
    rng = np.random.default_rng(nv * 3 + deg + d)
    nbrs = torch.from_numpy(rng.integers(0, rows, (nv, deg)).astype(np.int32))
    mask = torch.from_numpy(rng.random((nv, deg)) < density)
    r = torch.from_numpy(rng.normal(size=(nv, deg)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32))
    return tuple(t.to(device) for t in (nbrs, mask, r, x))


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("nv,deg,rows,d", ALS_SHAPES)
def test_als_kernel_matches_plain_version_on_card(cuda, nv, deg, rows, d,
                                                  density):
    args = _als_inputs(nv, deg, rows, d, density, cuda)
    want = als_port.als_normal_eq_plain(*args)
    before = als_port.als_normal_eq.launches
    got = als_port.als_normal_eq(*args)
    torch.cuda.synchronize()
    assert als_port.als_normal_eq.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, w)
    # the same call on the CPU runs the plain version: bitwise
    cpu = als_port.als_normal_eq(*(a.cpu() for a in args))
    for g, c in zip(got, cpu):
        assert torch.equal(g.cpu(), c)


def _als_stress(d, width, density, device, rows=300, nv=97):
    """ALS slots at one (d, width): out-of-range ids on real slots, two
    all-masked rows, and an inf row of x read only through masked slots."""
    rng = np.random.default_rng(d * 1000 + width * 3 + int(10 * density))
    nbrs = rng.integers(-4, rows + 4, (nv, width)).astype(np.int32)
    mask = rng.random((nv, width)) < density
    mask[[3, 50]] = False
    nbrs[nbrs == 7] = 8
    nbrs[~mask & (rng.random((nv, width)) < 0.5)] = 7
    r = rng.normal(size=(nv, width)).astype(np.float32)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    x[7] = np.inf
    return tuple(torch.from_numpy(t).to(device) for t in (nbrs, mask, r, x))


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("width", [0, 1, 5, 31, 64, 70, 667])
@pytest.mark.parametrize("d", [1, 3, 7, 17, 20, 33, 63, 64])
def test_als_kernel_bitwise_at_every_d_and_width(cuda, d, width, density):
    nbrs, mask, r, x = _als_stress(d, width, density, cuda)
    want = als_port.als_normal_eq_plain(nbrs, mask, r, x)
    got = als_port.als_normal_eq(nbrs, mask, r, x)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, w)
    assert torch.equal(got[0], got[0].transpose(1, 2))
    assert not got[0][[3, 50]].any() and not got[1][[3, 50]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 20, 64])
def test_als_kernel_reads_an_unaligned_x(cuda, d):
    # rows of x off a 16-byte boundary are copied 4 bytes at a time
    nbrs, mask, r, x = _als_stress(d, 70, 0.6, cuda)
    x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(-1, d)
    assert x.data_ptr() % 16 != 0
    want = als_port.als_normal_eq_plain(nbrs, mask, r, x)
    got = als_port.als_normal_eq(nbrs, mask, r, x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 5, 20, 64])
def test_als_fold_identity_mode_on_card(cuda, d):
    nbrs, mask, r, x = _als_stress(d, 70, 0.6, cuda)
    finite = torch.where(torch.isinf(x), 0.0, x)
    X = finite[nbrs.long().clamp(0, x.shape[0] - 1)]              # [B, D, d]
    X[~mask] = torch.inf                    # read only behind masks
    want = als_port.als_normal_eq_plain(None, mask, r, X.view(-1, d))
    before = als_port.als_normal_eq.launches
    got = als_port.als_normal_eq_fold(mask, r, X)
    torch.cuda.synchronize()
    assert als_port.als_normal_eq.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the fold reads the scope in place: a strided scope raises
    with pytest.raises(ValueError, match="contiguous"):
        als_port.als_normal_eq_fold(mask, r, X.transpose(0, 1).contiguous()
                                    .transpose(0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 16, 17, 20, 33])
def test_als_bucketed_launches_once_per_16_buckets(cuda, n):
    nbrs, mask, r, x = _als_inputs(400, 12, 500, 20, 0.7, cuda)
    rng = np.random.default_rng(n)
    cut = np.sort(rng.choice(np.arange(1, 400), n - 1, replace=False))
    spans = [slice(a, b) for a, b in zip([0, *cut], [*cut, 400])]
    blocks = []
    for i, sp in enumerate(spans):         # widths 1..12, an empty bucket
        wd = 1 + i % 12
        blocks.append((nbrs[sp, :wd].contiguous(), mask[sp, :wd].contiguous(),
                       r[sp, :wd].contiguous()))
        if i == 1:
            blocks.append((nbrs[:0, :4], mask[:0, :4], r[:0, :4]))
    want = [als_port.als_normal_eq_plain(*blk, x) for blk in blocks]
    before = als_port.als_normal_eq.launches
    a, b = als_port.als_normal_eq_bucketed(*zip(*blocks), x)
    torch.cuda.synchronize()
    assert als_port.als_normal_eq.launches == before + -(-n // 16)
    assert torch.equal(a, torch.cat([w[0] for w in want]))
    assert torch.equal(b, torch.cat([w[1] for w in want]))


@pytest.mark.cuda
def test_als_entry_points_share_the_launch(cuda):
    nbrs, mask, r, x = _als_inputs(300, 12, 400, 20, 0.7, cuda)
    before = als_port.als_normal_eq.launches
    one = als_port.als_normal_eq(nbrs, mask, r, x)
    split = als_port.als_normal_eq_bucketed(
        [nbrs[:100], nbrs[100:]], [mask[:100], mask[100:]],
        [r[:100], r[100:]], x)
    batched = als_port.als_normal_eq_batched(nbrs, mask, r, x)
    fold = als_port.als_normal_eq_fold(mask, r, x[nbrs.long()])
    for got in (split, batched, fold):
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
    # one launch each: the bucketed call's two buckets share one
    assert als_port.als_normal_eq.launches == before + 4


@pytest.mark.cuda
def test_als_masked_slots_are_skipped_on_card(cuda):
    nbrs, mask, r, x = _als_inputs(40, 6, 30, 5, 0.6, cuda)
    mask[:, 2] = False
    nbrs[:, 2] = 29
    nbrs[:, [0, 1, 3, 4, 5]] %= 29               # row 29 only behind masks
    x[29] = torch.inf
    a, b = als_port.als_normal_eq(nbrs, mask, r, x)
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    want = als_port.als_normal_eq_plain(nbrs, mask, r, x)
    assert torch.equal(a, want[0]) and torch.equal(b, want[1])


@pytest.mark.cuda
def test_als_launch_errors_raise(cuda):
    nbrs, mask, r, x = _als_inputs(4, 3, 5, 65, 0.6, cuda)
    before = als_port.als_normal_eq.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        als_port.als_normal_eq(nbrs, mask, r, x)       # d = 65 > 64
    assert als_port.als_normal_eq.launches == before


@pytest.mark.cuda
def test_als_wrapper_raises_on_cuda_arguments_it_does_not_take(cuda):
    nbrs, mask, r, x = _als_inputs(10, 4, 20, 8, 0.6, cuda)
    for bad in (x.bfloat16(), x.double()):
        with pytest.raises(ValueError, match="float32"):
            als_port.als_normal_eq(nbrs, mask, r, bad)
    with pytest.raises(ValueError, match="contiguous"):
        als_port.als_normal_eq(nbrs, mask, r, torch.cat([x, x], 1)[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        als_port.als_normal_eq(nbrs.t().contiguous().t(), mask, r, x)


def _normal_equations(graph, color):
    ids, _ = build_color_batches(graph.colors.cpu().numpy())
    ids = torch.from_numpy(ids[color]).to(graph.device)
    scope = gather_scopes(graph, graph.vertex_data, graph.edge_data, ids, {})
    return als_port.als_normal_eq_fold(
        scope.nbr_mask, scope.edge_data["rating"], scope.nbr_data["w"])


@pytest.mark.cuda
def test_gpu_als_equals_cpu_als(cuda):
    prob = als.synthetic_netflix(300, 200, d=8, density=0.06, device="cpu")
    g, upd, syncs = als.build(prob, lam=0.05, eps=0.0)
    for c in range(g.n_colors):
        a_c, b_c = _normal_equations(g, c)
        a_g, b_g = _normal_equations(g.to(cuda), c)
        assert torch.equal(a_g.cpu(), a_c) and torch.equal(b_g.cpu(), b_c)
    cpu = api.run(g, upd, syncs=syncs, device="cpu", num_supersteps=5)
    before = als_port.als_normal_eq.launches
    gpu = api.run(g, upd, syncs=syncs, device=cuda, num_supersteps=5)
    # the update reached the CUDA launch: one fold per group of the
    # color-major phase plan (the two colors' rows at each stored width)
    groups = sum(len(blocks.rows) for _, _, blocks in gpu.engine.plan.phases)
    assert groups >= 2
    assert als_port.als_normal_eq.launches == before + groups * 5
    assert (gpu.superstep, gpu.n_updates) == (cpu.superstep, cpu.n_updates)
    torch.testing.assert_close(gpu.vertex_data["w"].cpu(),
                               cpu.vertex_data["w"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gpu.globals["rmse"].cpu(), cpu.globals["rmse"],
                               rtol=1e-5, atol=0.0)


# (b, h, hkv, w, dh): n_rep 1, 2, 4, 7 and 16; dh from 16 to 256, 100
# not a multiple of 32; W from 1 to beyond one split, 513 not a multiple
# of a tile
ATTN_SHAPES = [
    (1, 1, 1, 1, 16),
    (3, 4, 4, 64, 64),
    (2, 8, 4, 513, 128),
    (4, 32, 8, 2048, 128),
    (2, 7, 1, 700, 100),
    (1, 16, 1, 300, 64),
    (2, 8, 2, 1500, 256),
    (5, 4, 2, 9000, 32),
]


def _attn_inputs(b, h, hkv, w, dh, dtype, device, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, h, dh), generator=gen)
    k = torch.randn((b, w, hkv, dh), generator=gen).to(dtype)
    v = torch.randn((b, w, hkv, dh), generator=gen).to(dtype)
    kvl = torch.randint(1, w + 1, (b,), generator=gen, dtype=torch.int32)
    kvl[0] = w
    if b > 1:
        kvl[1] = 1
    return q.to(device), k.to(device), v.to(device), kvl.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,w,dh", ATTN_SHAPES)
def test_window_attention_matches_plain_version_on_card(cuda, b, h, hkv, w,
                                                        dh, dtype):
    q, k, v, kvl = _attn_inputs(b, h, hkv, w, dh, dtype, cuda)
    before = wa.window_attention.launches
    got = wa.window_attention(q, k, v, kvl)
    torch.cuda.synchronize()
    assert wa.window_attention.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, h, dh)
    want = decode_window_attention_ref(q, k, v, kvl)
    assert float((got - want).abs().max()) <= 1e-5
    cpu = wa.window_attention(q.cpu(), k.cpu(), v.cpu(), kvl.cpu())
    assert float((got.cpu() - cpu).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_window_attention_reads_a_layer_slice_in_place(cuda):
    """A [B, W, Hkv, dh] slice of the stacked cache (strided batch) and a
    bf16 q give what contiguous float32 copies give."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    cache = torch.randn((3, 2, 600, 8, 128), generator=gen).to(
        torch.bfloat16).to(cuda)
    q = torch.randn((2, 32, 128), generator=gen).to(torch.bfloat16).to(cuda)
    kvl = torch.tensor([600, 37], dtype=torch.int32, device=cuda)
    got = wa.window_attention(q, cache[1], cache[2], kvl)
    want = wa.window_attention(q.float(), cache[1].contiguous(),
                               cache[2].contiguous(), kvl)
    assert torch.equal(got, want)
    plain = decode_window_attention_ref(q, cache[1], cache[2], kvl)
    assert float((got - plain).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_unaligned_k_reads_elements(cuda, dtype):
    """K whose rows do not start on 16 bytes (a view one element into a
    wider buffer) takes the element-wise read and agrees all the same."""
    gen = torch.Generator(device="cpu").manual_seed(4)
    buf = torch.randn((2, 300, 4, 129), generator=gen).to(dtype).to(cuda)
    k = buf[..., 1:]
    v = torch.randn((2, 300, 4, 128), generator=gen).to(dtype).to(cuda)
    q = torch.randn((2, 8, 128), generator=gen).to(cuda)
    kvl = torch.tensor([300, 123], dtype=torch.int32, device=cuda)
    got = wa.window_attention(q, k, v, kvl)
    want = decode_window_attention_ref(q, k, v, kvl)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_window_attention_splits_past_kv_len_weigh_nothing(cuda):
    """A long W with short kv_len: most splits lie wholly past kv_len
    (m = -inf, l = 0) and the combine must give them weight 0, not NaN."""
    q, k, v, _ = _attn_inputs(4, 8, 2, 32768, 64, torch.bfloat16, cuda)
    kvl = torch.tensor([1, 2, 129, 32768], dtype=torch.int32, device=cuda)
    chunk, n_splits = wa.split_rows(
        4 * 2, 32768, torch.cuda.get_device_properties(
            cuda).multi_processor_count, 4, 64, torch.bfloat16,
        wa.body_info(cuda, 64)["blocks_per_sm"])
    assert n_splits > 4 and chunk > 129
    got = wa.window_attention(q, k, v, kvl)
    assert bool(torch.isfinite(got).all())
    want = decode_window_attention_ref(q, k, v, kvl)
    assert float((got - want).abs().max()) <= 1e-5
    # kv_len = 1 returns row 0 of V exactly
    assert torch.equal(got[0], v[0, 0].float().repeat_interleave(4, dim=0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,w,dh", ATTN_SHAPES)
def test_window_attention_partial_entry_on_card(cuda, b, h, hkv, w, dh,
                                                dtype):
    """The partial entry (one launch, unnormalised o with its m and l)
    against its plain version, a request with no row among them: o / l
    within 1e-5 of the whole attention, (0, -inf, 0) for the empty one,
    and m, l and o within 1e-5 relative of the plain partial's."""
    q, k, v, kvl = _attn_inputs(b, h, hkv, w, dh, dtype, cuda)
    kvl[-1] = 0
    before = wa.window_attention.launches
    o, m, l = wa.window_attention_partial(q, k, v, kvl)
    torch.cuda.synchronize()
    assert wa.window_attention.launches == before + 1
    po, pm, pl = decode_window_attention_partial_ref(q, k, v, kvl)
    assert (o[-1] == 0).all() and torch.isinf(m[-1]).all() \
        and (l[-1] == 0).all()
    if b > 1:
        full = decode_window_attention_ref(q[:-1], k[:-1], v[:-1], kvl[:-1])
        got = o[:-1] / l[:-1][..., None]
        assert float((got - full).abs().max()) <= 1e-5
        assert torch.allclose(m[:-1], pm[:-1], rtol=1e-5, atol=1e-5)
        assert torch.allclose(l[:-1], pl[:-1], rtol=1e-5, atol=0)
        # o is relative to each launch's own m: compare it scaled to m
        scale = torch.exp(pm[:-1] - m[:-1])[..., None]
        assert torch.allclose(o[:-1] * scale, po[:-1], rtol=1e-5,
                              atol=1e-5 * float(po.abs().max()))


def _edge_lens(w, chunk):
    """kv_len at 1, either side of a tile edge and of a split edge, W."""
    lens = [1, 63, 64, 65, chunk - 1, chunk, chunk + 1, w]
    return torch.tensor([min(max(n, 1), w) for n in lens], dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [513, 8191])
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 7, 8])
def test_window_attention_tensor_core_body(cuda, n_rep, dh, w):
    """The bf16 cache's body (q and p as two bf16 terms on mma.sync)
    against the float32 plain version within 1e-5, at every group size a
    block holds, dh up to 256, W not a whole number of tiles, and kv_len
    on both sides of a tile's and a split's edge."""
    hkv = 2
    chunk, n = wa.split_rows(8 * hkv, w, torch.cuda.get_device_properties(
        cuda).multi_processor_count, n_rep, dh, torch.bfloat16,
        wa.body_info(cuda, dh)["blocks_per_sm"])
    q, k, v, _ = _attn_inputs(8, hkv * n_rep, hkv, w, dh, torch.bfloat16,
                              cuda, seed=n_rep * 1000 + dh + w)
    kvl = _edge_lens(w, chunk).to(cuda)
    before = wa.window_attention.launches
    got = wa.window_attention(q, k, v, kvl)
    torch.cuda.synchronize()
    assert wa.window_attention.launches == before + 1
    want = decode_window_attention_ref(q, k, v, kvl)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_window_attention_tickets_reset_between_launches(cuda):
    """Launches of different shapes back to back on one stream, with no
    wait between them: each merges its own splits (the last split of a
    group zeroes its ticket), one counted launch a call."""
    shapes = [(4, 32, 8, 32768, 128), (3, 8, 2, 8191, 64),
              (4, 32, 8, 32768, 128), (2, 4, 4, 9000, 256)]
    cases = []
    for i, (b, h, hkv, w, dh) in enumerate(shapes):
        q, k, v, _ = _attn_inputs(b, h, hkv, w, dh, torch.bfloat16, cuda,
                                  seed=20 + i)
        kvl = torch.full((b,), w, dtype=torch.int32, device=cuda)
        kvl[-1] = w // 2 + 1
        cases.append((q, k, v, kvl))
    before = wa.window_attention.launches
    outs = [wa.window_attention(*c) for c in cases]
    torch.cuda.synchronize()
    assert wa.window_attention.launches == before + len(cases)
    for c, got in zip(cases, outs):
        assert float((got - decode_window_attention_ref(*c)).abs().max()) \
            <= 1e-5


@pytest.mark.cuda
def test_reference_signature_shares_the_launch(cuda):
    q, k, v, kvl = _attn_inputs(6, 1, 1, 1000, 64, torch.float32, cuda)
    before = wa.window_attention.launches
    got = wa.decode_window_attention(q[:, 0], k[:, :, 0], v[:, :, 0], kvl)
    assert wa.window_attention.launches == before + 1
    assert torch.equal(got, wa.window_attention(q, k, v, kvl)[:, 0])


@pytest.mark.cuda
def test_window_attention_raises_on_cuda_arguments_it_does_not_take(cuda):
    q, k, v, kvl = _attn_inputs(2, 2, 1, 40, 300, torch.float32, cuda)
    with pytest.raises(ValueError, match="dh <= 256"):
        wa.window_attention(q, k, v, kvl)
    q, k, v, kvl = _attn_inputs(2, 2, 1, 40, 32, torch.float32, cuda)
    strided = torch.cat([k, k], dim=-1)[..., ::2]        # stride 2 in dh
    with pytest.raises(ValueError, match="unit stride"):
        wa.window_attention(q, strided, strided, kvl)
    with pytest.raises(ValueError, match="several devices"):
        wa.window_attention(q, k, v, kvl.cpu())


@pytest.mark.cuda
def test_gpu_decode_equals_cpu_decode(cuda, monkeypatch):
    """qwen3-4b reduced, float32 parameters, a random ring-wrapped cache:
    four decode steps on the GPU against the same steps on the CPU, the
    GPU's attention through the kernel (one launch a layer and step)."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.serve import engine
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = configs.get("qwen3-4b").reduced()
    params = model.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gparams = model.init_params(cfg, seed=0, dtype=torch.float32,
                                device="cpu").to(cuda)
    states = []
    for dev in ("cpu", cuda):
        st = engine.init_cache(cfg, 3, 96, dtype=torch.float32, device=dev)
        gen = torch.Generator(device="cpu").manual_seed(3)
        st.cache_k.copy_(torch.randn(st.cache_k.shape, generator=gen))
        st.cache_v.copy_(torch.randn(st.cache_v.shape, generator=gen))
        st.cache_len.copy_(torch.tensor([96, 5, 400], dtype=torch.int32))
        states.append(st)
    tok = torch.tensor([[3], [77], [500]], dtype=torch.int32)
    before = wa.window_attention.launches
    cst, gst = states
    for _ in range(4):
        cl, cst = engine.decode_step(params, cfg, tok, cst)
        gl, gst = engine.decode_step(gparams, cfg, tok.to(cuda), gst)
        torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
        tok = torch.argmax(cl[:, :cfg.vocab], dim=-1)[:, None].int()
    assert wa.window_attention.launches == before + 4 * cfg.n_layers
    torch.testing.assert_close(gst.cache_k.cpu(), cst.cache_k, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,dh", [(64, 4, 128), (64, 8, 128)])
def test_window_attention_at_the_moe_and_hybrid_groups(cuda, h, hkv, dh):
    """qwen3-moe's 64/4 heads (n_rep 16: two blocks of 8 query heads a
    KV head) and jamba's 64/8 (n_rep 8), bf16 and float32, ragged kv_len
    with 1 and W among them."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, kvl = _attn_inputs(3, h, hkv, 4096, dh, dtype, cuda,
                                    seed=h + hkv)
        got = wa.window_attention(q, k, v, kvl)
        want = decode_window_attention_ref(q, k, v, kvl)
        assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_window_attention_over_a_cross_attention_memory_slice(cuda):
    """seamless's cross-attention at decode: 16/16 heads of 64 over the
    whole memory (kv_len = W = T = 32,768), one layer's slice of the
    stacked ``[L, B, T, Hkv, dh]`` memory, read in place."""
    gen = torch.Generator(device="cpu").manual_seed(7)
    mem = torch.randn((2, 2, 2, 32768, 16, 64), generator=gen).to(
        torch.bfloat16).to(cuda)                  # [K/V, L, B, T, H, dh]
    q = torch.randn((2, 16, 64), generator=gen).to(cuda)
    kvl = torch.full((2,), 32768, dtype=torch.int32, device=cuda)
    got = wa.window_attention(q, mem[0, 1], mem[1, 1], kvl)
    want = decode_window_attention_ref(q, mem[0, 1], mem[1, 1], kvl)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b",
                                  "falcon-mamba-7b", "jamba-1.5-large-398b",
                                  "llava-next-34b", "seamless-m4t-medium"])
def test_gpu_family_decode_step_equals_cpu(cuda, monkeypatch, arch):
    """One reduced decode step of each family, float32 parameters, TF32
    off, from the same random state (caches, Mamba states, memory): the
    GPU's logits and state within 1e-4 of the CPU's, the GPU's
    attention through the kernel (one launch a self-attention layer and
    one a cross-attention layer)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.serve import engine
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = configs.get(arch).reduced()
    params = model.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gparams = model.init_params(cfg, seed=0, dtype=torch.float32,
                                device="cpu").to(cuda)
    cst = engine.init_cache(cfg, 3, 96, dtype=torch.float32, device="cpu")
    gen = torch.Generator(device="cpu").manual_seed(3)
    parts = [cst.cache_k, cst.cache_v, cst.mem_k, cst.mem_v] + (
        list(cst.mamba_state.values()) if cst.mamba_state else [])
    for t in parts:
        if t is not None:
            t.copy_(torch.randn(t.shape, generator=gen))
    to = lambda t: None if t is None else t.to(cuda)
    gst = dataclasses.replace(
        cst, cache_k=to(cst.cache_k), cache_v=to(cst.cache_v),
        cache_len=to(cst.cache_len), mem_k=to(cst.mem_k),
        mem_v=to(cst.mem_v),
        mamba_state=cst.mamba_state and {k: to(v) for k, v in
                                         cst.mamba_state.items()})
    tok = torch.tensor([[3], [77], [cfg.vocab - 1]], dtype=torch.int32)
    before = wa.window_attention.launches
    cl, cst = engine.decode_step(params, cfg, tok, cst)
    gl, gst = engine.decode_step(gparams, cfg, tok.to(cuda), gst)
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    assert wa.window_attention.launches == before + n_attn + (
        cfg.n_layers if cfg.enc_dec else 0)
    if cst.mamba_state is not None:
        torch.testing.assert_close(gst.mamba_state["h"].cpu(),
                                   cst.mamba_state["h"], rtol=1e-4,
                                   atol=1e-4)


# ----------------------------------------------------------------------
# The schedulers slice: window launches, CC / PageRank / CoEM on the card
# ----------------------------------------------------------------------

# scheduler -> options of the engine-level card runs
SCHED_CASES = {
    "chromatic": {},
    "bsp": {},
    "priority": {"k_select": 64},
    "priority_fifo": {"k_select": 64, "fifo": True},
    "locking": {"max_pending": 64},
}


def _sched(name):
    return name.split("_")[0]


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [1, 32])
@pytest.mark.parametrize("width", [2, 8, 64])
def test_window_launch_matches_plain_version(cuda, width, feat):
    """``ell_spmv_batched`` at a window's ``[B, W]`` shape, with rows
    narrower than W padded by zero-weight slots (as the batch dispatch
    gathers them), bitwise the plain version; the padded slots add
    exactly +0.0, so the result equals the same rows at their own
    width."""
    gen = torch.Generator(device=cuda).manual_seed(width * 100 + feat)
    b, n_src = 4096, 50_000
    real_w = torch.randint(1, width + 1, (b,), generator=gen, device=cuda)
    real = torch.arange(width, device=cuda)[None, :] < real_w[:, None]
    nbrs = torch.where(real, torch.randint(0, n_src, (b, width), generator=gen,
                                           device=cuda, dtype=torch.int32), 0)
    w = torch.where(real, torch.rand((b, width), generator=gen, device=cuda),
                    0.0)
    x = torch.rand((n_src, feat), generator=gen, device=cuda)
    mask = torch.rand(b, generator=gen, device=cuda) < 0.8
    y = port.ell_spmv_batched(nbrs.int(), w, x, mask)
    assert torch.equal(y, port.ell_spmv_plain(nbrs.int(), w, x, mask))
    wide = port.ell_spmv_batched(
        torch.nn.functional.pad(nbrs.int(), (0, 5)),
        torch.nn.functional.pad(w, (0, 5)), x, mask)
    assert torch.equal(wide, y)


def _cc_graph():
    from repro_torch.apps import cc
    edges = zipf_edges(2000, alpha=2.0, max_deg=64, seed=1)
    return cc.build(edges, 2000, device="cpu"), edges


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCHED_CASES) + ["locking_full"])
def test_gpu_cc_equals_cpu_cc_bitwise(cuda, name):
    from repro_torch.apps import cc
    from repro_torch.core.update import Consistency, UpdateFn
    (g, upd, _), edges = _cc_graph()
    if name == "locking_full":
        upd = UpdateFn(upd.fn, Consistency.FULL, name="cc")
    opts = SCHED_CASES.get(name, SCHED_CASES["locking"])
    cpu = api.run(g, upd, scheduler=_sched(name), device="cpu", **opts)
    gpu = api.run(g, upd, scheduler=_sched(name), device=cuda, **opts)
    assert torch.equal(gpu.vertex_data["label"].cpu(), cpu.vertex_data["label"])
    assert (gpu.superstep, gpu.n_updates) == (cpu.superstep, cpu.n_updates)
    assert not gpu.active_any
    np.testing.assert_array_equal(cpu.vertex_data["label"].numpy(),
                                  cc.reference_components(edges, 2000))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCHED_CASES))
def test_gpu_pagerank_schedulers_equal_cpu_bitwise(cuda, name):
    """Each engine on the card equals itself on the CPU, and its four
    launch shapes and arms agree bitwise on the card."""
    edges = zipf_edges(2000, alpha=2.0, max_deg=64, seed=1)
    g, upd, syncs = pagerank.build(edges, 2000, eps=1e-4, device="cpu")
    opts = dict(SCHED_CASES[name], num_supersteps=40)
    cpu = api.run(g, upd, syncs=syncs, scheduler=_sched(name), device="cpu",
                  **opts)
    runs = []
    for dispatch in ("bucket", "batch"):
        for use_kernel in (True, False):
            before = port.ell_spmv.launches
            runs.append(api.run(g, upd, syncs=syncs, scheduler=_sched(name),
                                device=cuda, dispatch=dispatch,
                                use_kernel=use_kernel, **opts))
            assert port.ell_spmv.launches > before
    for gpu in runs:
        assert torch.equal(gpu.vertex_data["rank"].cpu(),
                           cpu.vertex_data["rank"])
        assert (gpu.superstep, gpu.n_updates) == (cpu.superstep,
                                                  cpu.n_updates)
        assert torch.equal(gpu.state.active.cpu(), cpu.state.active)


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler", ["chromatic", "priority", "locking"])
def test_gpu_coem_kernel_arm_equals_dense_arm(cuda, scheduler):
    """CoEM at F = 3 types: the kernel arm equals the dense arm bitwise
    on the card under both launch shapes; the card is within 1e-6 of
    the CPU (the combine's type sum may reduce in another order)."""
    from repro_torch.apps import coem
    prob = coem.synthetic_ner(300, 120, 3, mean_deg=8, seed_frac=0.15,
                              seed=1, device="cpu")
    g, upd, syncs = coem.build(prob, eps=1e-4)
    opts = ({} if scheduler == "chromatic" else
            {"k_select": 32} if scheduler == "priority" else
            {"max_pending": 32})
    opts["num_supersteps"] = 30
    cpu = api.run(g, upd, syncs=syncs, scheduler=scheduler, device="cpu",
                  **opts)
    outs = [api.run(g, upd, syncs=syncs, scheduler=scheduler, device=cuda,
                    dispatch=d, use_kernel=k, **opts)
            for d in ("bucket", "batch") for k in (True, False)]
    for gpu in outs:
        assert torch.equal(gpu.vertex_data["p"], outs[0].vertex_data["p"])
        assert gpu.n_updates == outs[0].n_updates
    torch.testing.assert_close(outs[0].vertex_data["p"].cpu(),
                               cpu.vertex_data["p"], rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# Hub splitting: the segmented sum, split PageRank, Gibbs keys
# ----------------------------------------------------------------------

def _segment_case(case, device):
    """``(y, offsets)`` of a stress case of ``segment_sum_csr``."""
    from repro_torch.kernels import segment_combine as sc
    rng = np.random.default_rng(len(case))
    n_rows, tail, feat = 300, 0, (4,)
    lengths = rng.integers(0, 6, n_rows)
    if case == "empty":
        lengths[::2] = 0
    elif case == "long":
        lengths[7] = 5000            # longer than a block, many unrolls
    elif case == "sentinel":
        tail = 37
    elif case == "f1":
        feat = (1,)
    elif case == "f400":
        feat = (20, 20)
    elif case == "f_odd":
        feat = (7,)
    seg = np.concatenate([np.repeat(np.arange(n_rows), lengths),
                          np.full(tail, n_rows)])
    y = rng.normal(size=(len(seg),) + feat).astype(np.float32)
    if case == "negzero":
        y[rng.random(y.shape) < 0.5] = -0.0
        y[seg == 3] = -0.0
    offsets = sc.segment_offsets(torch.from_numpy(seg), n_rows)
    return torch.from_numpy(y).to(device), offsets.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["empty", "long", "sentinel", "negzero",
                                  "f1", "f400", "f_odd"])
def test_segment_sum_kernel_matches_plain_version_bitwise(cuda, case, dtype):
    from repro_torch.kernels import segment_combine as sc
    y, offsets = _segment_case(case, cuda)
    y = y.to(dtype)
    want = sc.segment_sum_csr_plain(y, offsets)
    before = sc.segment_sum_csr.launches
    got = sc.segment_sum_csr(y, offsets)
    torch.cuda.synchronize()
    assert sc.segment_sum_csr.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))
    assert torch.equal(got.cpu(), sc.segment_sum_csr(y.cpu(), offsets.cpu()))


def _segment_edge_case(case, off_dtype, device):
    """``(y, offsets)`` of an edge case of the staged kernel: spans and
    arrays that do not start on 16 bytes, segments longer than a stage
    or whose rows cross stages, ragged and empty tiles, feature slabs,
    decreasing offsets."""
    rng = np.random.default_rng(sum(map(ord, case)))
    n_rows, feat, most, first, cut, tail = 3000, (1,), 5, 0, 0, 0
    dtype = torch.float32
    lengths = None
    if case == "seg_2p20":
        n_rows = 64
        lengths = rng.integers(0, 6, n_rows)
        lengths[31] = 1 << 20
    elif case == "longer_than_a_stage_f400":
        n_rows, feat = 16, (400,)
        lengths = rng.integers(0, 6, n_rows)
        lengths[8] = 100
    elif case == "unaligned_f1":
        first, cut, tail = 3, 1, 3
    elif case == "unaligned_f7":
        feat, first, cut, tail = (7,), 1, 3, 2
    elif case == "unaligned_bf16_f20":
        feat, first, cut, tail, dtype = (20,), 5, 1, 1, torch.bfloat16
    elif case == "across_stages_f1":
        n_rows, most = 20_000, 300
    elif case == "across_stages_f32":
        n_rows, feat, most = 2000, (32,), 200
    elif case == "ragged_tiles":
        n_rows = 10_007
    elif case == "empty_tiles":
        n_rows = 10_000
        lengths = np.zeros(n_rows, np.int64)
        lengths[-10:] = rng.integers(1, 6, 10)
    elif case == "slabs":
        n_rows, feat, most = 7, (5000,), 3
    elif case == "empty_x":
        lengths = np.zeros(n_rows, np.int64)
    if lengths is None:
        lengths = rng.integers(0, most + 1, n_rows)
    offsets = np.concatenate([[0], np.cumsum(lengths)]) + first
    if case == "decreasing":
        offsets = rng.integers(-5, int(offsets[-1]) + 5, n_rows + 1)
    n_src = max(int(offsets[-1]), 0) + tail
    base = torch.from_numpy(rng.normal(size=(n_src + cut,) + feat).astype(
        np.float32)).to(device).to(dtype)
    y = base[cut:]              # x's first byte off 16 bytes when cut
    return y, torch.from_numpy(offsets).to(off_dtype).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("off_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", [
    "seg_2p20", "longer_than_a_stage_f400", "unaligned_f1", "unaligned_f7",
    "unaligned_bf16_f20", "across_stages_f1", "across_stages_f32",
    "ragged_tiles", "empty_tiles", "slabs", "empty_x", "decreasing"])
def test_segment_sum_kernel_edge_cases_bitwise(cuda, case, off_dtype):
    """The staged kernel against its plain version (the host's serial
    sum for the segment of 2^20 rows), bitwise, with either offset
    type."""
    from repro_torch.kernels import segment_combine as sc
    y, offsets = _segment_edge_case(case, off_dtype, cuda)
    want = (sc.segment_sum_csr_serial if case == "seg_2p20"
            else sc.segment_sum_csr_plain)(y.cpu(), offsets.cpu())
    before = sc.segment_sum_csr.launches
    got = sc.segment_sum_csr(y, offsets)
    torch.cuda.synchronize()
    assert sc.segment_sum_csr.launches == before + 1
    view = torch.int16 if y.dtype == torch.bfloat16 else torch.int32
    assert got.dtype == y.dtype and got.shape == want.shape
    assert torch.equal(got.cpu().view(view), want.view(view))


@pytest.mark.cuda
def test_segment_sum_launch_plan_is_the_builds(cuda):
    """The loaded build reports the geometry the CPU tests plan with,
    and its plans fit the card's shared memory."""
    from repro_torch.kernels import segment_combine as sc
    assert sc.geometry() == sc.DEFAULT_GEOMETRY
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = sc.launch_plan(2_097_152, 2_133_236, 1, 4, 4, n_sm)
    limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    assert plan.smem_bytes <= limit


@pytest.mark.cuda
def test_segment_combine_on_card_takes_ids_in_any_order(cuda):
    from repro_torch.kernels import segment_combine as sc
    rng = np.random.default_rng(3)
    seg = torch.from_numpy(rng.integers(0, 50, 3000))
    y = torch.from_numpy(rng.normal(size=(3000, 5)).astype(np.float32))
    before = sc.segment_sum_csr.launches
    got = sc.segment_combine(y.to(cuda), seg.to(cuda), 40)
    assert sc.segment_sum_csr.launches == before + 1
    assert torch.equal(got.cpu(), sc.segment_combine(y, seg, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chromatic", "bsp", "priority", "locking"])
def test_gpu_split_pagerank_equals_cpu_in_every_arm(cuda, name):
    """PageRank on the 2k Zipf graph split at w_cap = 8: the four arms on
    the card equal the CPU's run bitwise, and the combine runs through
    the segment_combine kernel."""
    from repro_torch.kernels import segment_combine as sc
    edges = zipf_edges(2000, alpha=2.0, max_deg=64, seed=1)
    g, upd, syncs = pagerank.build(edges, 2000, eps=1e-4, w_cap=8,
                                   device="cpu")
    assert g.ell.is_split
    opts = ({"num_supersteps": 10} if name in ("chromatic", "bsp") else
            {"k_select": 64, "num_supersteps": 10} if name == "priority"
            else {"max_pending": 64, "num_supersteps": 10})
    cpu = api.run(g, upd, syncs=syncs, scheduler=name, device="cpu", **opts)
    before = sc.segment_sum_csr.launches
    for dispatch in ("bucket", "batch"):
        for use_kernel in (True, False):
            gpu = api.run(g, upd, syncs=syncs, scheduler=name, device=cuda,
                          dispatch=dispatch, use_kernel=use_kernel, **opts)
            assert torch.equal(gpu.vertex_data["rank"].cpu(),
                               cpu.vertex_data["rank"]), (dispatch,
                                                          use_kernel)
            assert (gpu.superstep, gpu.n_updates) == (cpu.superstep,
                                                      cpu.n_updates)
    assert sc.segment_sum_csr.launches > before


@pytest.mark.cuda
def test_gibbs_keys_and_uniforms_on_card_equal_cpu(cuda):
    from repro_torch.apps import gibbs
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.integers(0, 2 ** 32, (100_000, 2),
                                      dtype=np.int64))
    k[0] = torch.tensor([2 ** 32 - 1, 2 ** 32 - 1])
    a, b = gibbs.split(k)
    ga, gb = gibbs.split(k.to(cuda))
    assert torch.equal(ga.cpu(), a) and torch.equal(gb.cpu(), b)
    assert torch.equal(gibbs.uniform(gb).cpu(), gibbs.uniform(b))
    assert torch.equal(gibbs.prng_key(torch.arange(1000, device=cuda)).cpu(),
                       gibbs.prng_key(torch.arange(1000)))


@pytest.mark.cuda
def test_calibrate_smoke_on_card(cuda, tmp_path, monkeypatch):
    """``python -m repro_torch.profile.calibrate --smoke`` on the card:
    every record timed, one fit point a (width, B), its files written
    under ``$REPRO_TORCH_RESULTS_DIR`` and refitting to the same model;
    it records the CPU's (kind, mode, width, rows) sequence."""
    from repro_torch.profile import (CostModel, fit_cost_model,
                                     load_cost_model, load_trace)
    from repro_torch.profile import calibrate
    monkeypatch.setenv("REPRO_TORCH_RESULTS_DIR", str(tmp_path))
    assert calibrate.main(["--smoke"]) == 0
    trace = load_trace(tmp_path / "TRACE_cuda.json")
    model = CostModel.load(tmp_path / "COSTMODEL_cuda.json")
    assert trace.device == model.device == "cuda"
    assert fit_cost_model(trace.records, device="cuda") == model
    assert load_cost_model() == model
    assert all(r["wall_us"] > 0 for r in trace.records)
    cpu, _ = calibrate.calibrate(device="cpu", emit=lambda *_: None,
                                 **dict(calibrate.SMOKE_SIZES, iters=1))
    key = lambda r: (r["kind"], r.get("mode"), r.get("width"), r.get("rows"))
    assert [key(r) for r in trace.records] == [key(r) for r in cpu.records]


def _window_runs(cuda):
    edges = zipf_edges(2000, alpha=2.0, max_deg=64, seed=1)
    g, upd, syncs = pagerank.build(edges, 2000, eps=1e-4, device=cuda)
    return g, upd, syncs, (("priority", {"k_select": 64}),
                           ("locking", {"max_pending": 64}),
                           ("chromatic", {}))


@pytest.mark.cuda
def test_profile_on_card_is_bitwise_a_plain_run(cuda):
    g, upd, syncs, cases = _window_runs(cuda)
    for sched, opts in cases:
        plain = api.run(g, upd, syncs=syncs, scheduler=sched,
                        num_supersteps=10, device=cuda, **opts)
        prof = api.run(g, upd, syncs=syncs, scheduler=sched, profile=True,
                       num_supersteps=10, device=cuda, **opts)
        assert torch.equal(prof.vertex_data["rank"],
                           plain.vertex_data["rank"]), sched
        assert prof.n_updates == plain.n_updates
        steps = [r for r in prof.profile.records if r["kind"] == "step"]
        assert len(steps) == 10 and steps[0]["cold"]
        assert prof.profile.device == cuda.type


class _Force:
    """A cost model that prices one arm cheaper at every shape."""

    def __init__(self, pick):
        self._batch_t = 1.0 if pick == "batch" else 2.0

    def predict(self, width, rows):
        return self._batch_t

    def predict_launches(self, launches):
        return 1.5


@pytest.mark.cuda
@pytest.mark.parametrize("pick", ["batch", "bucket"])
def test_auto_under_a_model_equals_the_forced_arm_on_card(cuda, pick):
    g, upd, syncs, cases = _window_runs(cuda)
    for sched, opts in cases[:2]:      # the window engines: "auto" there
        forced = api.run(g, upd, syncs=syncs, scheduler=sched,
                         dispatch=pick, num_supersteps=10, device=cuda,
                         **opts)
        auto = api.run(g, upd, syncs=syncs, scheduler=sched,
                       dispatch="auto", cost_model=_Force(pick),
                       num_supersteps=10, device=cuda, **opts)
        assert auto.engine.resolve_dispatch(64) == pick, sched
        assert torch.equal(auto.vertex_data["rank"],
                           forced.vertex_data["rank"]), sched
        assert (auto.superstep, auto.n_updates) == (forced.superstep,
                                                    forced.n_updates)


# ----------------------------------------------------------------------
# The distributed engines: eight shards on the card == on the CPU
# ----------------------------------------------------------------------

def _zipf2k(device, app):
    from repro_torch.apps import cc
    edges = zipf_edges(2000, alpha=2.0, max_deg=64, seed=1)
    if app == "cc":
        return cc.build(edges, 2000, device=device)
    return pagerank.build(edges, 2000, eps=1e-4, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("app,sched", [("pagerank", "chromatic"),
                                       ("cc", "chromatic"),
                                       ("cc", "locking")])
def test_local_mesh_on_card_equals_cpu(cuda, app, sched):
    """A ``LocalMesh`` of 8 shards on the card against the same 8 shards
    on the CPU (two-phase partition, seed 0): bitwise, counts included,
    and the kernel launched on the card."""
    key = "rank" if app == "pagerank" else "label"
    opts = {"scheduler": sched}
    if sched == "locking":
        opts["max_pending"] = 64
    runs = []
    for dev in ("cpu", cuda):
        g, upd, syncs = _zipf2k(dev, app)
        before = port.ell_spmv.launches
        runs.append(api.run(g, upd, syncs=syncs, n_shards=8, device=dev,
                            max_supersteps=4000, **opts))
        launched = port.ell_spmv.launches - before
    cpu, gpu = runs
    assert torch.equal(cpu.vertex_data[key], gpu.vertex_data[key].cpu())
    assert (cpu.superstep, cpu.n_updates) == (gpu.superstep, gpu.n_updates)
    assert not gpu.active_any
    if app == "pagerank":
        assert launched > 0


@pytest.mark.cuda
def test_nccl_mesh_at_world_size_one_equals_local_mesh(cuda):
    """``ProcessGroupMesh`` over NCCL (one rank, a TCP store on
    localhost) runs the 2k PageRank bitwise the ``LocalMesh`` run."""
    import socket

    import torch.distributed as dist

    from repro_torch.core.mesh import ProcessGroupMesh
    g, upd, syncs = _zipf2k(cuda, "pagerank")
    zeros = np.zeros(2000, np.int64)
    local = api.run(g, upd, syncs=syncs, n_shards=1, partition=zeros,
                    device=cuda)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port_no = sock.getsockname()[1]
    store = dist.TCPStore("localhost", port_no, 1, True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        pg = api.run(g, upd, syncs=syncs, n_shards=1, partition=zeros,
                     device=cuda, mesh=ProcessGroupMesh(device=cuda))
    finally:
        dist.destroy_process_group()
    assert torch.equal(local.vertex_data["rank"], pg.vertex_data["rank"])
    assert (local.superstep, local.n_updates) == (pg.superstep, pg.n_updates)


@pytest.mark.cuda
def test_mpi_als_on_card_equals_cpu(cuda):
    from repro_torch.baselines.mpi_als import als_mpi
    got = []
    for dev in ("cpu", cuda):
        prob = als.synthetic_netflix(200, 60, d=8, density=0.2, seed=3,
                                     device=dev)
        wu, wv, _ = als_mpi(prob, 5, n_devices=4, lam=0.02)
        got.append(torch.cat([wu, wv]).cpu())
    # normal equations bitwise; LAPACK's and cuSOLVER's LU differ
    torch.testing.assert_close(got[1], got[0], rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------
# Fault tolerance and online serving on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
def test_8shard_kill_resume_on_card_is_bitwise(cuda, tmp_path):
    """Eight ``LocalMesh`` shards on the card: a checkpoint-write
    failure, a kill and a transient fault recover to the unfaulted run,
    ranks, counts and ghost traffic bitwise."""
    from repro_torch.core.partition import two_phase_partition
    from repro_torch.ft import FaultEvent, FaultPlan
    edges = zipf_edges(400, alpha=2.0, max_deg=32, seed=3)
    g, upd, syncs = pagerank.build(edges, 400, device=cuda)
    asg = two_phase_partition(400, g.edges_np, 8, seed=0)
    for sched in ("chromatic", "locking"):
        kw = dict(syncs=syncs, scheduler=sched, n_shards=8, partition=asg,
                  num_supersteps=10, device=cuda)
        if sched == "locking":
            kw["max_pending"] = 16
        base = api.run(g, upd, **kw)
        r = api.run(g, upd, **kw, checkpoint_every=2,
                    checkpoint_dir=str(tmp_path / sched),
                    faults=FaultPlan([FaultEvent("checkpoint_fail", 4),
                                      FaultEvent("kill", 5, shard=3),
                                      FaultEvent("transient", 7)]))
        assert [x.restored_superstep for x in r.restarts] == [2, 4, 6]
        assert torch.equal(base.vertex_data["rank"], r.vertex_data["rank"])
        assert (base.superstep, base.n_updates) == (r.superstep, r.n_updates)
        assert base.stats.get("ghost_rows_sent") == r.stats.get(
            "ghost_rows_sent")


@pytest.mark.cuda
def test_snapshot_written_on_card_finishes_on_cpu(cuda, tmp_path):
    """Sharded and single-device snapshots written on the card load on
    a ``device="cpu"`` engine and finish bitwise the card's run (CC: no
    float arithmetic for the two devices to order differently)."""
    from repro_torch.apps import cc
    edges = zipf_edges(500, alpha=2.0, max_deg=32, seed=4)
    g, upd, _ = cc.build(edges, 500, device=cuda)
    for kw in (dict(scheduler="locking", max_pending=16),
               dict(scheduler="chromatic", n_shards=4,
                    partition=np.arange(500) % 4)):
        d = tmp_path / str(len(kw))
        full = api.run(g, upd, num_supersteps=8, checkpoint_every=4,
                       checkpoint_dir=str(d), device=cuda, **kw)
        snap = (d / "step_00000004" if "n_shards" in kw
                else d / "state_step_00000004.npz")
        kw.pop("partition", None)
        cpu = api.run(g.to("cpu"), upd, num_supersteps=8,
                      resume_from=str(snap), device="cpu", **kw)
        assert torch.equal(full.vertex_data["label"].cpu(),
                           cpu.vertex_data["label"])
        assert (full.superstep, full.n_updates) == (cpu.superstep,
                                                    cpu.n_updates)


@pytest.mark.cuda
@pytest.mark.parametrize("sched", ["chromatic", "locking"])
def test_serving_replay_on_card_equals_rebuild(cuda, sched):
    from repro_torch.apps import cc
    from repro_torch.data.pipeline import edge_stream
    nv = 2000
    edges = zipf_edges(nv, alpha=2.0, max_deg=64, seed=1)
    g, upd, _ = cc.build(edges, nv, slack=4, device=cuda)
    kw = {"max_pending": 256} if sched == "locking" else {}
    serving = api.serve(g, upd, scheduler=sched, device=cuda, **kw)
    pinned = serving.snapshot()
    before = pinned.vertex_data["label"].clone()
    serving.recompute()
    added = []
    for batch in edge_stream(nv, rate=64, seed=0, n_batches=4):
        fresh = np.asarray([e for e in batch.edges.tolist()
                            if serving.find_edge(*e) is None],
                           np.int64).reshape(-1, 2)
        serving.add_edges(fresh)
        added.extend(fresh.tolist())
        serving.recompute()
    all_edges = np.vstack([edges, np.asarray(added, np.int64)])
    assert torch.equal(pinned.vertex_data["label"], before)
    g2, u2, _ = cc.build(all_edges, nv, device=cuda)
    res = api.run(g2, u2, scheduler="chromatic", device=cuda)
    assert torch.equal(serving.graph.vertex_data["label"],
                       res.vertex_data["label"])
    assert np.array_equal(res.vertex_data["label"].cpu().numpy(),
                          cc.reference_components(all_edges, nv))


def _loss_and_grads(model_lib, params, cfg, batch, remat=True):
    named = list(params.named_parameters())
    with model_lib.trainable(params):
        loss, _ = model_lib.forward(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True, materialize_grads=True)
    return loss.detach(), {n: g for (n, _), g in zip(named, grads)}


def _normwise(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm()) if float(
        want.norm()) > 0 else float(got.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "jamba-1.5-large-398b"])
def test_training_on_card_equals_cpu(cuda, arch, monkeypatch):
    """The reduced config in float32, TF32 off: the loss within 1e-5 and
    each gradient normwise within 1e-4 of the CPU's; three train steps
    with their losses within 1e-5 and each parameter's update normwise
    within 1e-3 (Adam's m / sqrt(v) makes an element-wise bound test an
    ulp's noise at a near-zero gradient)."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step, param_dict
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = configs.get(arch).reduced()
    cpu = model_lib.init_params(cfg, seed=0, dtype=torch.float32,
                                device="cpu")
    gpu = model_lib.Model(cfg, dtype=torch.float32, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    batch = pipeline.make_batch(cfg, 2, 16, seed=0, device="cpu")
    cl, cg = _loss_and_grads(model_lib, cpu, cfg, batch)
    gl, gg = _loss_and_grads(model_lib, gpu, cfg,
                             {k: v.to(cuda) for k, v in batch.items()})
    assert abs(float(gl) - float(cl)) <= 1e-5 * abs(float(cl))
    for k in cg:
        assert _normwise(gg[k], cg[k]) <= 1e-4, k
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    states = [adamw.init(param_dict(m)) for m in (cpu, gpu)]
    steps = [make_train_step(cfg, opt) for _ in range(2)]
    for i in range(3):
        b = pipeline.make_batch(cfg, 2, 16, seed=100003 + i, device="cpu")
        before = [{n: p.detach().clone() for n, p in m.named_parameters()}
                  for m in (cpu, gpu)]
        _, states[0], cm = steps[0](cpu, states[0], b)
        _, states[1], gm = steps[1](gpu, states[1],
                                    {k: v.to(cuda) for k, v in b.items()})
        assert abs(float(gm["loss"]) - float(cm["loss"])) <= \
            1e-5 * abs(float(cm["loss"]))
        gp = dict(gpu.named_parameters())
        for n, p in cpu.named_parameters():
            assert _normwise(gp[n].detach() - before[1][n],
                             p.detach() - before[0][n]) <= 1e-3, (i, n)


# ----------------------------------------------------------------------
# the dry run's meta form against the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_walked_attention_launches_and_counts_its_work(cuda, dtype):
    """Inside the op walker B4 still launches on the card, and counts
    ``attention_work`` at the full window, as its meta form does."""
    from repro_torch.roofline import op_walk
    b, h, hkv, w, dh = 2, 8, 2, 512, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, h, dh), generator=gen, device=cuda)
    k = torch.randn((b, w, hkv, dh), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, w, hkv, dh), generator=gen, device=cuda).to(dtype)
    kvl = torch.tensor([w, 300], dtype=torch.int32, device=cuda)
    before = wa.window_attention.launches
    counted = []
    for dev in (cuda, torch.device("meta")):
        args = [t.to(dev) for t in (q, k, v, kvl)]
        with op_walk.OpWalk() as walk:
            out = wa.window_attention(*args)
        c = walk.cost()
        counted.append((c.flops, c.bytes, walk.peak_bytes))
        assert out.shape == (b, h, dh) and out.device.type == dev.type
    assert wa.window_attention.launches == before + 1
    assert counted[0] == counted[1]
    nbytes, flops = wa.attention_work(b * w, b, h, hkv, dh,
                                      k.element_size())
    assert counted[0][:2] == (flops, nbytes)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "falcon-mamba-7b",
                                  "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_walked_step_on_card_equals_the_dry_run(cuda, arch, kind):
    """A reduced step walked on the card counts what the dry run counts
    on meta: the same FLOPs, the same bytes, the same peak."""
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.data import pipeline
    from repro_torch.launch import dryrun
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.roofline import op_walk
    from repro_torch.serve import engine as serve_engine
    from repro_torch.train.steps import (make_prefill_step, make_serve_step,
                                         make_train_step, param_dict)
    cfg = configs.get(arch).reduced()
    shape = InputShape("s", 128, 2, kind)
    meta, _ = dryrun.walk_step(cfg, shape, extrapolate_prefill=False)
    params = model_lib.init_params(cfg, seed=0, device=cuda)
    if kind == "decode":
        token = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
        state = serve_engine.init_cache(cfg, 2, 128, device=cuda)
        args = (params, token, state)
        step = make_serve_step(cfg)
    else:
        batch = pipeline.make_batch(cfg, 2, 128, device=cuda)
        if kind == "prefill":
            batch.pop("labels")
            args, step = (params, batch), make_prefill_step(cfg)
        else:
            args = (params, adamw.init(param_dict(params)), batch)
            step = make_train_step(cfg, adamw.AdamWConfig())
    card = dryrun.walk(lambda: step(*args), args)
    cm, cc = (op_walk.cost_from_records(w.trace) for w in (meta, card))
    assert cc.flops == cm.flops
    assert cc.bytes == pytest.approx(cm.bytes, rel=1e-6)
    assert card.peak_bytes == pytest.approx(meta.peak_bytes, rel=1e-6)


@pytest.mark.cuda
def test_als_color_plan_matches_the_routed_path_on_card(cuda):
    """ALS's sweeps on the color-major plan against the padded, routed
    phases on the card (heavy-tailed movies, rows of 1 to 3,001 slots):
    the same updates and task set; B3's normal equations and the
    prediction (cuBLAS's batched matmul) are the same at any scope
    width, but the batched LU's kernel moves with the batch's size (a
    group of one row against a color of 120), so the factors and the
    RMSE sync agree to the LU's rounding, carried through three sweeps:
    rtol = 1e-4, atol = 5e-5 (2.3e-5 at most measured on the H100,
    factors of ~0.1 to 1)."""
    rng = np.random.default_rng(31)
    n_users, n_movies, d = 3000, 120, 20
    deg = np.minimum(3000 // np.arange(1, n_movies + 1) + 1, n_users)
    users = np.concatenate([rng.choice(n_users, k, replace=False)
                            for k in deg])
    pairs = np.stack([users, np.repeat(np.arange(n_movies), deg)], axis=1)
    w0 = (rng.normal(size=(n_users + n_movies, d)) * 0.1).astype(np.float32)
    prob = als.from_ratings(n_users, n_movies, pairs,
                            rng.normal(size=len(users)).astype(np.float32),
                            d, w0, device=cuda)
    g, upd, syncs = als.build(prob, lam=0.01, eps=0.0)
    got = api.run(g, upd, syncs=syncs, scheduler="chromatic",
                  max_supersteps=3, device=cuda)
    ids, valid = (torch.from_numpy(a).to(cuda) for a in
                  build_color_batches(g.colors.cpu().numpy()))
    from repro_torch.core import exec as ex
    st = ex.init_engine_state(g.vertex_data, g.edge_data, g.n_vertices,
                              syncs, cuda)
    for step in range(3):
        carry = (st.vertex_data, st.edge_data, st.active, st.priority,
                 st.n_updates)
        for c in range(ids.shape[0]):
            carry = ex.apply_batch(g, upd, carry, ids[c], valid[c],
                                   st.globals)
        vd, ed, act, pri, n_upd = carry
        st = ex.EngineState(vd, ed, act, pri,
                            ex.refresh_syncs(syncs, st.globals, vd, step),
                            step + 1, n_upd)
    assert sum(len(p[2].rows) for p in got.engine.plan.phases) > 4
    assert got.n_updates == int(st.n_updates)
    assert torch.equal(got.state.active, st.active)
    for k in ("cnt", "is_movie"):
        assert torch.equal(got.vertex_data[k], st.vertex_data[k]), k
    for k in ("w", "err"):
        torch.testing.assert_close(got.vertex_data[k], st.vertex_data[k],
                                   rtol=1e-4, atol=5e-5)
    torch.testing.assert_close(got.globals["rmse"], st.globals["rmse"],
                               rtol=1e-4, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("store", ["plain", "hub_split", "slack"])
def test_build_sorts_on_card_equal_numpys(cuda, store):
    """The build's two sorts on the card (``stable_argsort`` over the
    edges' vertex ends, ``bucket_major_edge_order``'s first visits)
    against numpy's on the same input, and the whole graph built on the
    card against the one built on the CPU, on an unsplit store, one with
    its hubs split into rows of 16 slots and one with 3 free slots a row:
    bitwise, since a stable sort's permutation is unique."""
    from repro_torch.core import graph as port_graph
    kw = {"plain": {}, "hub_split": {"w_cap": 16},
          "slack": {"slack": 3}}[store]
    rng = np.random.default_rng(31)
    edges = np.concatenate([zipf_edges(3000, 2.0, seed=31),
                            np.stack([np.zeros(400, np.int64),
                                      rng.permutation(2999)[:400] + 1],
                                     axis=1)])
    flat = edges.reshape(-1)
    big = rng.integers(0, 5000, 3_000_000)
    for a in (flat, big):
        assert np.array_equal(port_graph.stable_argsort(a, cuda),
                              np.argsort(a, kind="stable"))
    card = DataGraph.from_edges(3000, edges, {}, edge_locality=False,
                                device=cuda, **kw)
    ell = card.ell
    assert (ell.starts[-1] > ell.n_rows) == (store == "hub_split")
    visits = np.concatenate([
        ell.edge_ids[b].cpu().numpy()[ell.nbr_mask[b].cpu().numpy()]
        for b in range(ell.n_buckets)]).astype(np.int64)
    _, first = np.unique(visits, return_index=True)
    assert np.array_equal(port_graph.bucket_major_edge_order(ell, len(edges)),
                          visits[np.sort(first)])
    on_card = DataGraph.from_edges(3000, edges, {}, device=cuda, **kw)
    on_cpu = DataGraph.from_edges(3000, edges, {}, device="cpu", **kw)
    assert np.array_equal(on_card.edge_perm, on_cpu.edge_perm)
    assert np.array_equal(on_card.edges_np, on_cpu.edges_np)
    assert (on_card.ell.widths, on_card.ell.starts) == (on_cpu.ell.widths,
                                                        on_cpu.ell.starts)
    for x, y in zip(on_card.ell.slots, on_cpu.ell.slots, strict=True):
        assert torch.equal(x.cpu(), y)
    assert torch.equal(on_card.ell.perm.cpu(), on_cpu.ell.perm)
