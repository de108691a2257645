"""``correct`` fails the control and the faults of the timed path.

The control is each configuration's reference in the next precision
down, put in the port's place (bfloat16 ranks and weights for PageRank's
float32).  The faults are
planted in the port underneath a whole run of the harness: a superstep
that returns its state unchanged, half of each batch left out, and an
answer altered where it is produced.  The cells run on one chip, so
there is no exchange between chips to leave out.
"""
import dataclasses

import pytest
import torch

from bench import harness
from bench.control import readings
from fixtures import CELLS, tiny_cell
from hostcard import HostCard

CPU = torch.device("cpu")


def _over(cell, nums):
    return [k for k, v in nums.items()
            if not v <= float(cell.limits[k]["limit"])]


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(name):
    cell = tiny_cell(name)
    rows = []
    readings([cell], [21, 22], [21, 22, 23], HostCard(torch), rows.append)
    prog = [r for r in rows if r["kind"] == "program"]
    ctrl = [r for r in rows if r["kind"] == "control"]
    assert len(prog) == 2 and len(ctrl) == 3
    for r in prog:
        assert not _over(cell, r["numbers"]), r
    for r in ctrl:
        assert _over(cell, r["numbers"]), r


def _unchanged_state(monkeypatch):
    from repro_torch.core import exec as ex

    def step(self, state):
        return dataclasses.replace(state, superstep=state.superstep + 1)
    monkeypatch.setattr(ex.ExecutorCore, "_superstep", step)


def _half_batch(monkeypatch):
    from repro_torch.core import exec as ex
    real = ex.apply_batch

    def half(struct, update_fn, carry, ids, valid, *a, **k):
        keep = torch.arange(ids.shape[0], device=ids.device) % 2 == 0
        return real(struct, update_fn, carry, ids, valid & keep, *a, **k)
    monkeypatch.setattr(ex, "apply_batch", half)


def _altered_answer(monkeypatch):
    from repro_torch.core import exec as ex
    real = ex.scatter_result

    def altered(struct, vdata, edata, ids, sel, scope, res):
        vdata, edata = real(struct, vdata, edata, ids, sel, scope, res)
        out = {}
        for k, v in vdata.items():
            if v.is_floating_point():
                v = v.clone()
                v[ids[0].long()] = v[ids[0].long()] * 1.05 + 0.01
            out[k] = v
        return out, edata
    monkeypatch.setattr(ex, "scatter_result", altered)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_faults_make_correct_false(name, fault, monkeypatch):
    cell = tiny_cell(name)
    if "max_supersteps" in cell.traffic["run"]:
        cell.traffic["run"]["max_supersteps"] = 30
    FAULTS[fault](monkeypatch)
    res = harness.run_cell(cell, 31, 0.01, False, HostCard(torch))
    assert res["correct"] is False
    assert res["failed"] == res["attempted"] >= 1
