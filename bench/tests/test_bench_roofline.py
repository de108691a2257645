"""The frozen byte and operation counts against shapes worked by hand."""
import pytest
import torch

from bench import roofline


def _adj(edges, n):
    e = torch.tensor(edges)
    src = torch.cat([e[:, 0], e[:, 1]])
    return {"src": src, "dst": torch.cat([e[:, 1], e[:, 0]]),
            "deg": torch.bincount(src, minlength=n)}


# a star: hub 0 joined to 1..4, and the edge 3-4
STAR = ([[0, 1], [0, 2], [0, 3], [0, 4], [3, 4]], 5)


def test_phase_counts_of_the_hub():
    adj = _adj(*STAR)
    upd = roofline.updated_mask(torch, 5, torch.tensor([0, 0], dtype=torch.int32),
                                torch.tensor([True, False]))
    slots, read, out = roofline.phase_counts(torch, adj, upd)
    assert (float(slots), float(read), float(out)) == (4.0, 4.0, 1.0)


def test_phase_counts_of_the_leaves():
    adj = _adj(*STAR)
    ids = torch.tensor([1, 2, 3, 4, 0], dtype=torch.int32)
    sel = torch.tensor([True, True, True, True, False])
    slots, read, out = roofline.phase_counts(
        torch, adj, roofline.updated_mask(torch, 5, ids, sel))
    # degrees 1 + 1 + 2 + 2; they read 0, 3 and 4
    assert (float(slots), float(read), float(out)) == (6.0, 3.0, 4.0)


def test_spmv_work():
    nbytes, flops = roofline.spmv_work(6.0, 3.0, 4.0)
    assert nbytes == 6 * 8 + 3 * 4 + 4 * 4 and flops == 12
    nbytes, flops = roofline.spmv_work(6.0, 3.0, 4.0, features=32)
    assert nbytes == 6 * 8 + 3 * 128 + 4 * 128 and flops == 6 * 64


def test_least_seconds_takes_the_larger_bound():
    assert roofline.least_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert roofline.least_seconds(0.0, 67e12) == pytest.approx(1.0)
    assert roofline.least_seconds(3.35e12, 134e12) == pytest.approx(2.0)


def test_phase_batch_reads_the_task_set():
    from bench import harness
    metric = harness.load_module(harness.HERE / "metrics"
                                 / "ell_spmv_roofline.py")
    ids = torch.tensor([2, 0, 1], dtype=torch.int32)
    valid = torch.tensor([True, True, False])
    active = torch.tensor([False, True, True])   # active[ids]: T, F, T
    carry = (None, None, active, None, None)
    got_ids, sel = metric.phase_batch((None, None, carry, ids, valid), {})
    assert got_ids is ids and sel.tolist() == [True, False, False]
