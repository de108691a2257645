"""The port's ``SyncOp(sequential=True)`` and ``valid=`` masks against
the reference's ``repro.core.sync``.

The same numpy inputs go through both packages.  Every comparison is
bitwise: the folds here only add, take maxima or pick a row, so no
fused multiply-add can separate XLA's CPU code from eager torch, and
the parallel path is the same pairwise halving tree in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sync as ref_sync
from repro_torch.core import sync as port_sync

SIZES = (1, 2, 7, 37, 100)


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10).astype(np.float32)
    valid = rng.random(n) < 0.6
    return x, valid


def _both(x):
    return {"x": jnp.asarray(x)}, {"x": torch.from_numpy(x)}


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _ops(sequential):
    """(reference, port) SyncOps of an order-free sum and of an
    order-dependent "last row" fold."""
    def fold(acc, row):
        return acc + row["x"]

    def last(acc, row):
        return row["x"]

    def merge(a, b):
        return a + b

    return [
        (ref_sync.SyncOp("s", fold, merge, lambda a: a, jnp.float32(0.0),
                         sequential=sequential),
         port_sync.SyncOp("s", fold, merge, lambda a: a,
                          torch.tensor(0.0), sequential=sequential)),
        (ref_sync.SyncOp("l", last, lambda a, b: b, lambda a: a,
                         jnp.float32(-1.0), sequential=sequential),
         port_sync.SyncOp("l", last, lambda a, b: b, lambda a: a,
                          torch.tensor(-1.0), sequential=sequential)),
    ]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sequential", [False, True])
def test_sync_matches_reference_bitwise(n, sequential):
    """With and without a ``valid`` mask, parallel tree or in-order
    scan: the port's accumulator is the reference's, bit for bit."""
    x, valid = _data(n, n)
    ref_v, port_v = _both(x)
    for ref_op, port_op in _ops(sequential):
        np.testing.assert_array_equal(
            _bits(port_op.run(port_v).numpy()), _bits(ref_op.run(ref_v)))
        got = port_op.run(port_v, torch.from_numpy(valid))
        want = ref_op.run(ref_v, jnp.asarray(valid))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("n", SIZES)
def test_sequential_fold_is_in_row_order(n):
    """The scan keeps the last valid row, the tree does not need to:
    ``sequential`` really folds in order, masked rows skipped."""
    x, valid = _data(n, n + 1)
    _, port_v = _both(x)
    _, last = _ops(True)[1]
    got = float(last.run(port_v, torch.from_numpy(valid)))
    want = float(x[valid][-1]) if valid.any() else -1.0
    assert got == want


@pytest.mark.parametrize("n", SIZES)
def test_top_two_with_valid_matches_reference(n):
    """The paper's top-2 sync over the valid rows only."""
    x, valid = _data(n, 2 * n)
    ref_v, port_v = _both(x)
    ref_op = ref_sync.top_two_sync("t", lambda r: r["x"])
    port_op = port_sync.top_two_sync("t", lambda r: r["x"])
    got = port_op.local_reduce(port_v, torch.from_numpy(valid))
    want = ref_op.local_reduce(ref_v, jnp.asarray(valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_reference_examples():
    """The reference's own cases: a sequential fold equals the parallel
    one for a commutative fold, and ``valid`` keeps rows 0 and 2."""
    vdata = {"x": torch.arange(37, dtype=torch.float32)}
    fold = lambda acc, row: acc + row["x"] * 2.0
    merge = lambda a, b: a + b
    par = port_sync.SyncOp("k", fold, merge, lambda a: a, torch.tensor(0.0))
    seq = port_sync.SyncOp("k", fold, merge, lambda a: a, torch.tensor(0.0),
                           sequential=True)
    np.testing.assert_allclose(float(par.run(vdata)), float(seq.run(vdata)),
                               rtol=1e-5)
    s = port_sync.sum_sync("total", lambda row: row["x"])
    vdata = {"x": torch.tensor([1.0, 2.0, 4.0, 8.0])}
    valid = torch.tensor([True, False, True, False])
    assert float(s.local_reduce(vdata, valid)) == 5.0
