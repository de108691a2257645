"""The port's ``ell_spmv`` entry points against the reference kernel
(Pallas, interpret mode) and the plain oracles.

On the CPU the wrappers run the plain slot loop.  Tolerances: bitwise at
F = 1 in float32.  At F > 1 the reference's interpret-mode kernel is one
XLA computation, and XLA vectorizes the slot loop over the feature axis
in ways that differ by an ulp in some elements, so float32 is held to
rtol = atol = 1e-5 there.  bfloat16 rounds at other places in the two
frameworks' oracles: 2e-2, the reference's own bf16 tolerance.  The
kernel itself is held to its plain version on the card, bitwise in
float32, by ``tests/test_torch_cuda.py`` (and by ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ell_spmv as ref_kernel
from repro.kernels import ref as ref_oracle
from repro_torch.kernels import ell_spmv as port
from repro_torch.kernels import ref as port_oracle

SHAPES = [                       # (nv, deg, rows, feat)
    (1, 1, 1, 1),                # tests/test_kernels.py's sweep
    (7, 3, 11, 5),
    (128, 8, 128, 32),
    (200, 7, 300, 20),
    (513, 16, 300, 129),
    (200, 8, 300, 1),            # PageRank's F = 1
    (64, 32, 100, 1),
    (300, 2, 300, 1),
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (None, jnp.bfloat16, torch.bfloat16)}


def _inputs(nv, deg, rows, feat, seed=None, with_mask=True):
    rng = np.random.default_rng(nv * 7 + deg if seed is None else seed)
    nbrs = rng.integers(0, rows, (nv, deg)).astype(np.int32)
    w = (rng.random((nv, deg)) * (rng.random((nv, deg)) < 0.7))
    x = rng.normal(size=(rows, feat))
    mask = rng.random(nv) < 0.8 if with_mask else None
    return nbrs, w, x, mask


def _to_jax(a, jdt):
    return None if a is None else jnp.asarray(a, jdt)


def _to_torch(a, tdt):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(tdt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("nv,deg,rows,feat", SHAPES)
def test_ell_spmv_matches_reference_kernel(nv, deg, rows, feat, dtype):
    _, jdt, tdt = DTYPES[dtype]
    nbrs, w, x, mask = _inputs(nv, deg, rows, feat)
    want = ref_kernel.ell_spmv(jnp.asarray(nbrs), _to_jax(w, jdt),
                               _to_jax(x, jdt), jnp.asarray(mask),
                               interpret=True)
    got = port.ell_spmv(torch.from_numpy(nbrs), _to_torch(w, tdt),
                        _to_torch(x, tdt), torch.from_numpy(mask))
    assert got.dtype == tdt and got.shape == (nv, feat)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    tol = 1e-5 if dtype == "f32" else 2e-2
    if dtype == "f32" and feat == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # the float32 oracle on the same (dtype-rounded) inputs
    oracle = port_oracle.ell_spmv_ref(
        torch.from_numpy(nbrs), _to_torch(w, tdt).float(),
        _to_torch(x, tdt).float(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("nv,deg,rows,feat", SHAPES[:5])
def test_port_oracle_matches_reference_oracle(nv, deg, rows, feat):
    nbrs, w, x, mask = _inputs(nv, deg, rows, feat)
    want = ref_oracle.ell_spmv_ref(jnp.asarray(nbrs), jnp.asarray(w, jnp.float32),
                                   jnp.asarray(x, jnp.float32),
                                   jnp.asarray(mask))
    got = port_oracle.ell_spmv_ref(torch.from_numpy(nbrs),
                                   _to_torch(w, torch.float32),
                                   _to_torch(x, torch.float32),
                                   torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,d,f", [(5, 3, 1), (40, 16, 1), (33, 62, 1),
                                   (12, 7, 6)])
def test_ell_fold_matches_reference(b, d, f):
    rng = np.random.default_rng(b + d)
    w = (rng.random((b, d)) * (rng.random((b, d)) < 0.6)).astype(np.float32)
    vals = rng.normal(size=(b, d, f)).astype(np.float32)
    mask = rng.random(b) < 0.7
    want = np.asarray(ref_kernel.ell_fold(jnp.asarray(w), jnp.asarray(vals),
                                          jnp.asarray(mask), interpret=True))
    got = port.ell_fold(torch.from_numpy(w), torch.from_numpy(vals),
                        torch.from_numpy(mask)).numpy()
    if f == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bucketed_and_batched_match_reference():
    rng = np.random.default_rng(3)
    rows, feat = 120, 1
    nbrs_b, w_b, m_b = [], [], []
    for nvb, wd in [(50, 2), (0, 4), (25, 4), (9, 9)]:
        nbrs_b.append(rng.integers(0, rows, (nvb, wd)).astype(np.int32))
        w_b.append(rng.random((nvb, wd)).astype(np.float32))
        m_b.append(rng.random(nvb) < 0.5)
    x = rng.normal(size=(rows, feat)).astype(np.float32)
    want = ref_kernel.ell_spmv_bucketed(
        [jnp.asarray(a) for a in nbrs_b], [jnp.asarray(a) for a in w_b],
        jnp.asarray(x), [jnp.asarray(a) for a in m_b], interpret=True)
    got = port.ell_spmv_bucketed(
        [torch.from_numpy(a) for a in nbrs_b],
        [torch.from_numpy(a) for a in w_b], torch.from_numpy(x),
        [torch.from_numpy(a) for a in m_b])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = ref_kernel.ell_spmv_batched(jnp.asarray(nbrs_b[0]),
                                       jnp.asarray(w_b[0]), jnp.asarray(x),
                                       interpret=True)
    got = port.ell_spmv_batched(torch.from_numpy(nbrs_b[0]),
                                torch.from_numpy(w_b[0]), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_version_rounds_each_product_then_adds_in_slot_order():
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 rounds to 1 + 2^-11 in float32;
    # slot 0 adds -(1 + 2^-11) first, so rounding the product gives 0
    # exactly, where a fused multiply-add would leave 2^-24
    e = 1.0 + 2.0 ** -12
    nbrs = torch.tensor([[0, 1]], dtype=torch.int32)
    w = torch.tensor([[1.0, e]])
    x = torch.tensor([[-(1.0 + 2.0 ** -11)], [e]])
    assert port.ell_spmv(nbrs, w, x).item() == 0.0
    masked = port.ell_spmv(nbrs, w, x, row_mask=torch.tensor([False]))
    assert masked.item() == 0.0


def test_wrapper_rejects_other_devices_and_mixed_inputs():
    nbrs = torch.zeros((2, 2), dtype=torch.int32)
    w = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.ell_spmv(nbrs.to("meta"), w.to("meta"),
                      torch.zeros((3, 1), device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        port.ell_spmv(nbrs, w.to("meta"), torch.zeros((3, 1)))


@pytest.mark.parametrize("args,msg", [
    ((torch.zeros((2, 2)), torch.zeros((2, 2)), torch.zeros((3, 1)), None),
     "int32"),
    ((torch.zeros((2, 2), dtype=torch.int32), torch.zeros((2, 3)),
      torch.zeros((3, 1)), None), "match"),
    ((torch.zeros((2, 2), dtype=torch.int32), torch.zeros((2, 2)),
      torch.zeros((3, 1), dtype=torch.float64), None), "dtype"),
    ((torch.zeros((2, 2), dtype=torch.int32), torch.zeros((2, 2)),
      torch.zeros((3, 4))[:, ::2], None), "contiguous"),
    ((torch.zeros((2, 2), dtype=torch.int32), torch.zeros((2, 2)),
      torch.zeros((3, 1)), torch.ones(3, dtype=torch.bool)), "row_mask"),
])
def test_cuda_argument_checks(args, msg):
    with pytest.raises(ValueError, match=msg):
        port._check_cuda_args(*args)


PLAN_CASES = [                   # (bucket (rows, width) shapes, F, tile, threads)
    (((1594285, 2), (221946, 4), (130973, 8), (72663, 16), (38170, 32),
      (19453, 64), (9770, 128), (9892, 256)), 1, 4096, 256),
    (((50, 2), (0, 4), (25, 4), (9, 9)), 1, 4096, 256),
    (((7, 3), (3, 667), (2, 1024), (5, 5000), (4, 0), (9, 1)), 1, 4096, 256),
    (((100, 8), (0, 16), (37, 62)), 32, 4096, 256),
    (((13, 1), (9, 2), (7, 3), (3, 17), (1, 70)), 1, 16, 4),
]


@pytest.mark.parametrize("shapes,feat,tile,threads", PLAN_CASES)
def test_plan_table_deals_every_row_once(shapes, feat, tile, threads):
    entries, n_blocks = port.plan_table(shapes, feat, tile, threads)
    # non-empty buckets only, widest first, ties in the caller's order
    order = [b for b, _, _, _ in entries]
    assert sorted(order) == [b for b, (nv, _) in enumerate(shapes) if nv]
    assert order == sorted(order, key=lambda b: -shapes[b][1])
    # output rows: the buckets one after another in the caller's order
    for b, _, _, out_row in entries:
        assert out_row == sum(nv for nv, _ in shapes[:b])
    # block ranges: contiguous from 0, each covering its rows once
    ends = [start for _, _, start, _ in entries[1:]] + [n_blocks]
    assert entries[0][2] == 0
    for (b, lg, start, _), end in zip(entries, ends):
        nv, width = shapes[b]
        group = 1 << lg
        assert group >= min(width, tile) and (group == 1 or group < 2 * width)
        assert group <= tile
        per_block = tile // group if feat == 1 else threads
        items = nv if feat == 1 else nv * feat
        assert (end - start - 1) * per_block < items <= (end - start) * per_block
    # a cached plan for the same shapes
    assert port.plan_table(shapes, feat, tile, threads) is \
        port.plan_table(shapes, feat, tile, threads)


def test_build_table_points_at_each_bucket():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(40, 1)).astype(np.float32))
    items = []
    for nv, width, mask in ((6, 2, None), (0, 8, None), (4, 16, "bool"),
                            (3, 3, "float")):
        nbrs = torch.from_numpy(rng.integers(0, 40, (nv, width))
                                .astype(np.int32))
        w = torch.from_numpy(rng.random((nv, width)).astype(np.float32))
        m = None if mask is None else torch.from_numpy(rng.random(nv) < 0.5)
        if mask == "float":
            m = m.double()
        items.append((nbrs, w, x, m))
    table, n_blocks, keep = port.build_table(items, 1)
    entries, want_blocks = port.plan_table(
        tuple(tuple(it[0].shape) for it in items), 1, port.TILE, port.THREADS)
    assert table.n == len(entries) == 3 and n_blocks == want_blocks
    for i, (b, lg, start, out_row) in enumerate(entries):
        nbrs, w, _, m = items[b]
        e = table.b[i]
        assert (e.nbrs, e.w, e.x) == (nbrs.data_ptr(), w.data_ptr(),
                                      x.data_ptr())
        assert (e.n_src, e.n_rows, e.width) == (40, *nbrs.shape)
        assert (e.lg_group, e.block_start, e.out_row) == (lg, start, out_row)
        if m is None:
            assert e.mask_kind == 0 and e.mask is None
        elif m.dtype == torch.bool:              # read as bytes, no cast
            assert e.mask_kind == 1 and e.mask == m.data_ptr()
        else:                                    # cast once to w's dtype
            assert e.mask_kind == 2
            cast = [k for k in keep if k.data_ptr() == e.mask]
            assert len(cast) == 1 and cast[0].dtype == torch.float32
            assert torch.equal(cast[0], m.float())


def test_table_checks_every_bucket():
    nbrs = torch.zeros((2, 2), dtype=torch.int32)
    w, x = torch.zeros((2, 2)), torch.zeros((3, 1))
    good = (nbrs, w, x, None)
    with pytest.raises(ValueError, match="match"):
        port._check_table([good, (nbrs, torch.zeros((2, 3)), x, None)])
    with pytest.raises(ValueError, match="row_mask"):
        port._check_table([good, (nbrs, w, x, torch.ones(3, dtype=torch.bool))])
    with pytest.raises(ValueError, match="feature count"):
        port._check_table([good, (nbrs, w, torch.zeros((3, 2)), None)])
    # a call takes any number of buckets; one launch's table at most
    # MAX_BUCKETS non-empty ones (empty ones take no entry)
    assert port._check_table([good] * (port.MAX_BUCKETS + 1)) == 1
    empty = (nbrs[:0], w[:0], x, None)
    table, _, _ = port.build_table([good] * port.MAX_BUCKETS + [empty] * 3, 1)
    assert table.n == port.MAX_BUCKETS
    with pytest.raises(ValueError, match=f"at most {port.MAX_BUCKETS}"):
        port.build_table([good] * (port.MAX_BUCKETS + 1), 1)


SPLIT_CASES = [                  # (bucket row counts, limit)
    ((5, 3, 0, 7), 16),                          # one launch
    ((0, 0), 16),                                # no launch
    (tuple(range(1, 21)), 16),                   # 20 buckets: 16 + 4
    ((4,) * 17, 16),                             # 17: 16 + 1
    ((2, 0) * 17 + (0,), 16),                    # empty ones ride along
    (tuple(range(33)), 16),                      # 32 non-empty: 16 + 16
    ((1, 0, 1, 1, 0, 0, 1, 1), 2),
]


@pytest.mark.parametrize("rows,limit", SPLIT_CASES)
def test_split_table_launches_at_most_limit_buckets(rows, limit):
    shapes = tuple((nv, 3) for nv in rows)
    runs = port.split_table(shapes, limit)
    n_full = sum(nv > 0 for nv in rows)
    assert len(runs) == -(-n_full // limit)
    # consecutive buckets in the caller's order, every non-empty one once
    covered = [b for lo, hi, _ in runs for b in range(lo, hi)]
    assert covered == sorted(covered) and len(set(covered)) == len(covered)
    assert {b for b, nv in enumerate(rows) if nv} <= set(covered)
    for lo, hi, row0 in runs:
        assert 0 < sum(nv > 0 for nv in rows[lo:hi]) <= limit
        assert row0 == sum(rows[:lo])          # the run's rows of the output
    assert port.split_table(shapes, limit) is port.split_table(shapes, limit)


def test_bucketed_call_over_more_buckets_than_a_launch_takes():
    # on the CPU the plain version runs bucket by bucket: 20 buckets, some
    # empty, equal the reference's per-bucket launches bucket for bucket
    rng = np.random.default_rng(8)
    rows = 60
    x = rng.normal(size=(rows, 1)).astype(np.float32)
    nbrs, ws, masks, want = [], [], [], []
    for b in range(20):
        nv, width = (0 if b % 7 == 3 else 4 + b % 3), 1 + b % 4
        nb = rng.integers(0, rows, (nv, width)).astype(np.int32)
        w = (rng.random((nv, width)) * (rng.random((nv, width)) < 0.7)
             ).astype(np.float32)
        m = rng.random(nv) < 0.8
        nbrs.append(nb)
        ws.append(w)
        masks.append(m)
    want = ref_kernel.ell_spmv_bucketed(
        [jnp.asarray(a) for a in nbrs], [jnp.asarray(a) for a in ws],
        jnp.asarray(x), [jnp.asarray(a) for a in masks], interpret=True)
    got = port.ell_spmv_bucketed(
        [torch.from_numpy(a) for a in nbrs], [torch.from_numpy(a) for a in ws],
        torch.from_numpy(x), [torch.from_numpy(a) for a in masks])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fold_bucketed_matches_reference_folds():
    rng = np.random.default_rng(11)
    ws, vs, ms, want = [], [], [], []
    for b, d in ((30, 2), (0, 4), (12, 16), (5, 62)):
        w = (rng.random((b, d)) * (rng.random((b, d)) < 0.6)).astype(np.float32)
        vals = rng.normal(size=(b, d, 1)).astype(np.float32)
        mask = rng.random(b) < 0.7
        ws.append(torch.from_numpy(w))
        vs.append(torch.from_numpy(vals))
        ms.append(torch.from_numpy(mask))
        want.append(np.asarray(ref_kernel.ell_fold(
            jnp.asarray(w), jnp.asarray(vals), jnp.asarray(mask),
            interpret=True)) if b else np.zeros((0, 1), np.float32))
    got = port.ell_fold_bucketed(ws, vs, ms).numpy()
    np.testing.assert_array_equal(got, np.concatenate(want))
