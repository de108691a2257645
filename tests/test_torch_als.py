"""The port's ALS (``repro_torch.apps.als``) and its ``als_normal_eq``
kernel against the reference, on the same numpy inputs.

On the CPU the kernel's wrappers run its plain version, an eager slot
loop that rounds each product before it adds it.  The reference kernel
in interpret mode is one XLA computation, and XLA on the CPU contracts
its ``a + xm * x`` into a fused multiply-add, so the two differ by an
ulp or so in some elements: they are held to rtol = atol = 1e-5 (the
largest difference over the shapes below is 5.7e-6, at d = 20).  The
einsum oracles are held at 1e-4, as ``tests/test_kernels.py`` holds the
reference kernel.  The kernel itself is held to its plain version on the
card, bitwise, by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

ALS runs are held to the reference's on the reference's own graph,
carried across with ``interop``: factors at rtol = 1e-4, atol = 1e-5
(the largest difference measured is 2.3e-6 after 100 supersteps), the
sync RMSE at 1e-5, and the superstep and update counts exactly (no eps
decision flips on these problems).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.apps import als as ref_als
from repro.core import coloring as ref_coloring
from repro.kernels import als_normal_eq as ref_kernel
from repro.kernels import ref as ref_oracle
from repro_torch import api, interop
from repro_torch.apps import BUILDERS, als, pagerank
from repro_torch.core import coloring
from repro_torch.kernels import als_normal_eq as port
from repro_torch.kernels import ref as port_oracle
from repro_torch.kernels.ell_spmv import split_table
from torch_parity import reference_arrays

ROOT = Path(__file__).resolve().parents[1]

SHAPES = [                       # (nv, deg, rows, d)
    (1, 1, 2, 2),                # tests/test_kernels.py's sweep
    (50, 5, 60, 4),
    (130, 9, 100, 8),
    (257, 6, 300, 16),
    (200, 24, 300, 20),          # ALS's d = 20
]


def _inputs(nv, deg, rows, d):
    rng = np.random.default_rng(nv + d)
    nbrs = rng.integers(0, rows, (nv, deg)).astype(np.int32)
    mask = rng.random((nv, deg)) < 0.6
    r = rng.normal(size=(nv, deg)).astype(np.float32)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    return nbrs, mask, r, x


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("nv,deg,rows,d", SHAPES)
def test_als_normal_eq_matches_reference_kernel(nv, deg, rows, d):
    args = _inputs(nv, deg, rows, d)
    a, b = port.als_normal_eq(*_torch(*args))
    assert a.dtype == b.dtype == torch.float32
    assert a.shape == (nv, d, d) and b.shape == (nv, d)
    want_a, want_b = ref_kernel.als_normal_eq(*_jax(*args), interpret=True)
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(want_b), rtol=1e-5,
                               atol=1e-5)
    for oracle_a, oracle_b in (ref_oracle.als_normal_eq_ref(*_jax(*args)),
                               port_oracle.als_normal_eq_ref(*_torch(*args))):
        np.testing.assert_allclose(a.numpy(), np.asarray(oracle_a),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(b.numpy(), np.asarray(oracle_b),
                                   rtol=1e-4, atol=1e-4)
    # unmasked products are x_i * x_k both ways round: A is symmetric
    assert torch.equal(a, a.transpose(1, 2))


def test_bucketed_batched_and_fold_entries_match_reference():
    rng = np.random.default_rng(3)
    rows, d = 120, 8
    blocks = []
    for nvb, wd in [(50, 2), (0, 4), (25, 4), (9, 9)]:
        blocks.append((rng.integers(0, rows, (nvb, wd)).astype(np.int32),
                       rng.random((nvb, wd)) < 0.7,
                       rng.normal(size=(nvb, wd)).astype(np.float32)))
    x = rng.normal(size=(rows, d)).astype(np.float32)
    nb, mk, rt = zip(*blocks)
    want = ref_kernel.als_normal_eq_bucketed(
        _jax(*nb), _jax(*mk), _jax(*rt), jnp.asarray(x), interpret=True)
    got = port.als_normal_eq_bucketed(_torch(*nb), _torch(*mk), _torch(*rt),
                                      torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    nbrs, mask, r = _torch(*blocks[0])
    want = ref_kernel.als_normal_eq_batched(*_jax(*blocks[0]),
                                            jnp.asarray(x), interpret=True)
    one = port.als_normal_eq(nbrs, mask, r, torch.from_numpy(x))
    batched = port.als_normal_eq_batched(nbrs, mask, r, torch.from_numpy(x))
    # the fold of the gathered (unmasked) scope is the same accumulation
    fold = port.als_normal_eq_fold(mask, r, torch.from_numpy(x)[nbrs.long()])
    for g in (batched, fold):
        assert torch.equal(g[0], one[0]) and torch.equal(g[1], one[1])
    for g, w in zip(one, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("density", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("d", [1, 3, 20, 33, 64])
def test_plain_version_is_bitwise_symmetric(d, density):
    # x_i * x_k and x_k * x_i are one IEEE product, added in the same
    # slot order: A == A^T bitwise, which lets the kernel compute the
    # upper triangle only and mirror it
    rng = np.random.default_rng(d)
    nv, width, rows = 24, 13, 40
    nbrs = rng.integers(-3, rows + 3, (nv, width)).astype(np.int32)
    mask = rng.random((nv, width)) < density
    r = rng.normal(size=(nv, width)).astype(np.float32)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    a, b = port.als_normal_eq_plain(*_torch(nbrs, mask, r, x))
    assert torch.equal(a, a.transpose(1, 2))
    assert bool((a != 0).any()) == bool(mask.any())


ALS_PLAN_CASES = [               # (bucket (rows, width) shapes, rows a block)
    (((48019, 667),), 4),                        # a fold
    (((50, 2), (0, 4), (25, 4), (9, 9)), 4),     # an empty bucket
    (((7, 3), (3, 667), (2, 0), (5, 64), (4, 4)), 1),
    (tuple((3 + b % 5, 1 + b % 6) for b in range(20)), 4),   # 20 buckets
]


@pytest.mark.parametrize("shapes,rows_per_block", ALS_PLAN_CASES)
def test_als_plan_table_deals_every_row_once(shapes, rows_per_block):
    for lo, hi, row0 in split_table(shapes, port.MAX_BUCKETS):
        run = shapes[lo:hi]
        entries, n_blocks = port.plan_table(run, rows_per_block)
        # non-empty buckets only, widest first, ties in the caller's order
        order = [b for b, _, _ in entries]
        assert sorted(order) == [b for b, (nv, _) in enumerate(run) if nv]
        assert order == sorted(order, key=lambda b: -run[b][1])
        assert len(entries) <= port.MAX_BUCKETS
        # output rows: the run's buckets one after another, from row0
        for b, _, out_row in entries:
            assert out_row == sum(nv for nv, _ in run[:b])
            assert row0 + out_row == sum(nv for nv, _ in shapes[:lo + b])
        # blocks: contiguous from 0, each bucket's rows covered once
        ends = [start for _, start, _ in entries[1:]] + [n_blocks]
        assert not entries or entries[0][1] == 0
        for (b, start, _), end in zip(entries, ends):
            nv = run[b][0]
            assert (end - start - 1) * rows_per_block < nv
            assert nv <= (end - start) * rows_per_block
    assert port.plan_table(shapes[:3], 4) is port.plan_table(shapes[:3], 4)


def test_build_table_points_at_each_als_bucket():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(30, 5)).astype(np.float32))
    items = []
    for nv, width in ((6, 2), (0, 8), (4, 16), (3, 3)):
        nbrs, mask, r, _ = _torch(*_inputs(nv, width, 30, 5))
        items.append((nbrs, mask, r, x))
    items.append((None, items[0][1], items[0][2], x[:12]))    # a fold
    table, n_blocks = port.build_table(items, 2)
    entries, want = port.plan_table(
        tuple(tuple(it[1].shape) for it in items), 2)
    assert table.n == len(entries) == 4 and n_blocks == want
    for i, (bk, start, out_row) in enumerate(entries):
        nbrs, mask, r, xs = items[bk]
        e = table.b[i]
        assert e.nbrs == (None if nbrs is None else nbrs.data_ptr())
        assert (e.mask, e.ratings, e.x) == (mask.data_ptr(), r.data_ptr(),
                                            xs.data_ptr())
        assert (e.n_src, e.n_rows, e.width) == (xs.shape[0], *mask.shape)
        assert (e.block_start, e.out_row) == (start, out_row)
    with pytest.raises(ValueError, match=f"at most {port.MAX_BUCKETS}"):
        port.build_table(items[:1] * (port.MAX_BUCKETS + 1), 2)


def test_fold_identity_mode_is_the_gather_through_the_identity_index():
    nbrs, mask, r, x = _torch(*_inputs(37, 11, 50, 6))
    X = x[nbrs.long()]                                   # [B, D, d]
    idx = torch.arange(37 * 11, dtype=torch.int32).reshape(37, 11)
    want = port.als_normal_eq_plain(idx, mask, r, X.reshape(-1, 6))
    for got in (port.als_normal_eq_plain(None, mask, r, X.reshape(-1, 6)),
                port.als_normal_eq_fold(mask, r, X),
                port.als_normal_eq(nbrs, mask, r, x)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="identity gather"):
        port._check_args(None, mask, r, X.reshape(-1, 6)[:-1])
    with pytest.raises(ValueError, match=r"\[B, D, d\]"):
        port.als_normal_eq_fold(mask, r, x)


def test_bucketed_over_more_buckets_than_a_launch_takes_matches_reference():
    # 20 buckets (3 empty), more than one launch takes: the bucketed entry
    # and the fold of each bucket's gathered scope against the
    # reference's per-bucket launches in interpret mode (ids past the end
    # clamp in both; jnp would wrap negative ones)
    rng = np.random.default_rng(12)
    rows, d = 90, 8
    blocks = []
    for b in range(20):
        nv, width = (0 if b % 7 == 2 else (5, 9)[b % 2]), (3, 6)[b % 3 == 0]
        blocks.append((rng.integers(0, rows + 2, (nv, width)).astype(np.int32),
                       rng.random((nv, width)) < 0.7,
                       rng.normal(size=(nv, width)).astype(np.float32)))
    x = rng.normal(size=(rows, d)).astype(np.float32)
    nb, mk, rt = zip(*blocks)
    want = ref_kernel.als_normal_eq_bucketed(
        _jax(*nb), _jax(*mk), _jax(*rt), jnp.asarray(x), interpret=True)
    got = port.als_normal_eq_bucketed(_torch(*nb), _torch(*mk), _torch(*rt),
                                      torch.from_numpy(x))
    xt = torch.from_numpy(x)
    folds = [port.als_normal_eq_fold(m, r, xt[n.long().clamp(0, rows - 1)])
             for n, m, r in (_torch(*blk) for blk in blocks)]
    fold = (torch.cat([f[0] for f in folds]), torch.cat([f[1] for f in folds]))
    for g, f, w in zip(got, fold, want):
        assert g.shape == w.shape and torch.equal(g, f)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_plain_version_rounds_each_product_then_adds_in_slot_order():
    # e^2 = (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 rounds to 1 + 2^-11 in
    # float32; slot 0 adds -(1 + 2^-11) first, so rounding the product
    # gives 0 exactly, where a fused multiply-add would leave 2^-24
    e = 1.0 + 2.0 ** -12
    c = -(1.0 + 2.0 ** -11)
    nbrs = torch.tensor([[0, 1]], dtype=torch.int32)
    mask = torch.tensor([[True, True]])
    r = torch.tensor([[c, e]])
    x = torch.tensor([[1.0, c], [e, e]])
    a, b = port.als_normal_eq(nbrs, mask, r, x)
    assert a[0, 0, 1].item() == a[0, 1, 0].item() == 0.0
    assert b[0, 0].item() == 0.0


def test_masked_slots_are_skipped():
    nbrs, mask, r, x = _torch(*_inputs(40, 6, 29, 5))
    x = torch.cat([x, x[:1]])
    mask[:, 2] = False
    nbrs[:, 2] = 29                              # row 29 only behind masks
    poisoned = x.clone()
    poisoned[29] = torch.inf
    zeroed = x.clone()
    zeroed[29] = 0.0
    a, b = port.als_normal_eq(nbrs, mask, r, poisoned)
    a0, b0 = port.als_normal_eq(nbrs, mask, r, zeroed)
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    assert torch.equal(a, a0) and torch.equal(b, b0)
    # for finite x, skipping is bitwise the reference's multiply by 0
    want = ref_kernel.als_normal_eq(*_jax(nbrs.numpy(), mask.numpy(),
                                          r.numpy(), zeroed.numpy()),
                                    interpret=True)
    np.testing.assert_allclose(a0.numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("change,msg", [
    (lambda a: dict(a, x=a["x"].double()), "float32"),
    (lambda a: dict(a, x=a["x"].bfloat16()), "float32"),
    (lambda a: dict(a, ratings=a["ratings"].double()), "float32"),
    (lambda a: dict(a, mask=a["mask"].float()), "bool"),
    (lambda a: dict(a, nbrs=a["nbrs"].long()), "int32"),
    (lambda a: dict(a, ratings=a["ratings"][:, :1]), "match"),
    (lambda a: dict(a, x=a["x"][0]), "2-D"),
])
def test_wrapper_rejects_arguments_it_does_not_take(change, msg):
    nbrs, mask, r, x = _torch(*_inputs(4, 3, 5, 2))
    args = change(dict(nbrs=nbrs, mask=mask, ratings=r, x=x))
    with pytest.raises(ValueError, match=msg):
        port.als_normal_eq(**args)


def test_wrapper_rejects_other_devices_and_layouts():
    nbrs, mask, r, x = _torch(*_inputs(4, 3, 5, 2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.als_normal_eq(nbrs.to("meta"), mask.to("meta"), r.to("meta"),
                           x.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        port.als_normal_eq(nbrs, mask, r, x.to("meta"))
    with pytest.raises(ValueError, match="contiguous"):
        port._check_contiguous(nbrs, mask, r, torch.cat([x, x], 1)[:, ::2])


@pytest.mark.parametrize("n_left,n", [(0, 5), (3, 3), (40, 70)])
def test_bipartite_coloring_matches_reference(n_left, n):
    got = coloring.bipartite_coloring(n_left, n)
    want = ref_coloring.bipartite_coloring(n_left, n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block_rows", [1, 3, 7, 64])
def test_rating_mask_blocks_leave_the_generator_as_one_draw_does(block_rows):
    one, blocked = np.random.default_rng(5), np.random.default_rng(5)
    want = np.nonzero(one.random((23, 11)) < 0.3)
    got = als._rating_pairs(blocked, 23, 11, 0.3, block_rows)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(blocked.normal(size=4), one.normal(size=4))


@pytest.mark.parametrize("block_rows", [7, 40])
def test_synthetic_netflix_matches_reference(block_rows, monkeypatch):
    # 7 rows a block does not divide the 40 users; 40 is one block
    monkeypatch.setattr(als, "MASK_BLOCK_DOUBLES", block_rows * 30)
    want = ref_als.synthetic_netflix(40, 30, d=4, density=0.4, seed=2)
    got = als.synthetic_netflix(40, 30, d=4, density=0.4, seed=2,
                                device="cpu")
    assert (got.n_users, got.n_movies, got.d, got.noise) == (
        want.n_users, want.n_movies, want.d, want.noise)
    np.testing.assert_array_equal(got.ratings, want.ratings)
    np.testing.assert_array_equal(got.pairs, want.pairs)
    arrays, meta = interop.graph_to_arrays(got.graph)
    ref_arrays, ref_meta = reference_arrays(want.graph)
    assert meta == ref_meta
    assert sorted(arrays) == sorted(ref_arrays)
    for k, v in ref_arrays.items():
        assert arrays[k].dtype == v.dtype, k
        np.testing.assert_array_equal(arrays[k], v, err_msg=k)


CASES = {                        # (n_users, n_movies, d, density)
    "small": (40, 30, 4, 0.4),
    "mid": (300, 200, 8, 0.06),
}


@pytest.fixture(scope="module")
def als_runs():
    """Per case: the reference problem, the port's graph on the same
    storage, and the reference's fixed-budget and converged runs."""
    out = {}
    for name, (nu, nm, d, density) in CASES.items():
        prob = ref_als.synthetic_netflix(nu, nm, d=d, density=density)
        g, upd, syncs = ref_als.build(prob, lam=0.05, eps=1e-3)
        out[name] = dict(
            prob=prob, d=d,
            port_graph=interop.graph_from_arrays(*reference_arrays(g),
                                                 device="cpu"),
            fixed=ref_api.run(g, upd, syncs=syncs, num_supersteps=10),
            converged=ref_api.run(g, upd, syncs=syncs))
    return out


@pytest.mark.parametrize("mode", ["fixed", "converged"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_als_run_matches_reference(als_runs, name, mode):
    case = als_runs[name]
    budget = {"num_supersteps": 10} if mode == "fixed" else {}
    got = api.run(case["port_graph"], als.make_update(case["d"], lam=0.05,
                                                      eps=1e-3),
                  syncs=(als.rmse_sync(),), device="cpu", **budget)
    want = case[mode]
    assert (got.superstep, got.n_updates) == (want.superstep,
                                              int(want.n_updates))
    assert got.active_any == want.active_any
    for k in ("w", "err", "cnt"):
        np.testing.assert_allclose(got.vertex_data[k].numpy(),
                                   np.asarray(want.vertex_data[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got.globals["rmse"]),
                               float(want.globals["rmse"]), rtol=1e-5)


def test_port_problem_runs_as_the_reference_graph_carried_across(als_runs):
    """The port's own problem and the reference's graph carried across
    are one graph: the port's runs on them are bitwise equal."""
    case = als_runs["small"]
    prob = als.synthetic_netflix(40, 30, d=4, density=0.4, device="cpu")
    runs = [api.run(g, als.make_update(4, lam=0.05, eps=1e-3),
                    syncs=(als.rmse_sync(),), device="cpu", num_supersteps=4)
            for g in (prob.graph, case["port_graph"])]
    assert torch.equal(runs[0].vertex_data["w"], runs[1].vertex_data["w"])
    assert runs[0].globals["rmse"].item() == runs[1].globals["rmse"].item()


def test_sync_rmse_matches_dataset_rmse():
    """As ``tests/test_apps.py`` holds the reference: the sync op's RMSE
    is the exact dataset RMSE, and ALS reaches the noise floor."""
    prob = als.synthetic_netflix(40, 30, d=4, density=0.4, noise=0.05,
                                 device="cpu")
    graph, update, syncs = als.build(prob, lam=0.01, eps=1e-4)
    res = api.run(graph, update, syncs=syncs, device="cpu",
                  num_supersteps=60)
    rmse = als.dataset_rmse(prob, res.vertex_data)
    assert rmse < 0.09
    np.testing.assert_allclose(float(res.globals["rmse"]), rmse, rtol=1e-3)


def test_update_takes_its_normal_equations_from_the_kernel_entry(
        monkeypatch):
    calls = []

    def counted(mask, ratings, X):
        calls.append(tuple(X.shape))
        return port.als_normal_eq_fold(mask, ratings, X)

    monkeypatch.setattr(als, "als_normal_eq_fold", counted)
    prob = als.synthetic_netflix(40, 30, d=4, density=0.4, device="cpu")
    api.run(*als.build(prob)[:2], device="cpu", num_supersteps=3)
    # one fold per color phase, at the scope's [Cmax, max_deg, d]
    assert calls == [(40, prob.graph.max_deg, 4)] * 6


def test_update_keeps_tf32_off_and_restores_the_setting(monkeypatch):
    seen = []
    solve_ex = torch.linalg.solve_ex

    def spy(A, B):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return solve_ex(A, B)

    monkeypatch.setattr(torch.linalg, "solve_ex", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    prob = als.synthetic_netflix(40, 30, d=4, density=0.4, device="cpu")
    api.run(*als.build(prob)[:2], device="cpu", num_supersteps=1)
    assert seen == [False, False]
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_builders_name_the_ported_apps():
    from repro_torch.apps import bptf, cc, coem, gibbs, lbp
    assert BUILDERS == {"pagerank": pagerank.build, "als": als.build,
                        "cc": cc.build, "coem": coem.build,
                        "lbp": lbp.build, "gibbs": gibbs.build,
                        "bptf": bptf.build}


def test_netflix_example_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "netflix_als_torch.py"),
         "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "sync RMSE" in proc.stdout
