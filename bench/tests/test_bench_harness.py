"""The harness end to end on the CPU: result line, metrics and checks."""
import json

import pytest
import torch

from bench import harness
from fixtures import CELLS, tiny_cell
from hostcard import HostCard

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(name, traced, seconds=0.05, seed=2 ** 31 + 11):
    return harness.run_cell(tiny_cell(name), seed, seconds, traced,
                            HostCard(torch))


@pytest.mark.parametrize("name", CELLS)
def test_untraced_line(name):
    res = _run(name, False)
    assert list(res) == KEYS + ["checks"]     # checks come last
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    cell = harness.load_cell(name)
    want = {m["name"] for m in cell.end_to_end}
    assert set(res["metrics"]) == want
    for m in cell.end_to_end:
        assert res["metrics"][m["name"]]["unit"] == m["unit"]
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(res)


@pytest.mark.parametrize("name", CELLS)
def test_traced_line(name):
    res = _run(name, True)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert res["correct"] is True
    assert res["attempted"] >= 4          # the window's and three traced
    cell = harness.load_cell(name)
    # no device here: the device's own metrics read nothing
    host = {m["name"] for m in cell.per_layer} - {"idle_pct", "device_busy_ms"}
    assert set(res["metrics"]) == host
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["metrics"]["supersteps"]["value"] >= 1


def test_same_seed_same_inputs():
    cell = tiny_cell("pagerank-zipf.chromatic")
    a = cell.adapter.generate(torch, cell.config, 7, torch.device("cpu"))
    b = cell.adapter.generate(torch, cell.config, 7, torch.device("cpu"))
    c = cell.adapter.generate(torch, cell.config, 8, torch.device("cpu"))
    assert (a["edges"] == b["edges"]).all()
    assert a["edges"].shape != c["edges"].shape or (
        a["edges"] != c["edges"]).any()


def test_missing_limit_is_an_error():
    cell = tiny_cell("pagerank-zipf.chromatic")
    cell.limits = {k: v for k, v in cell.limits.items()
                   if k != "rank_gap_max"}
    with pytest.raises(KeyError, match="rank_gap_max"):
        harness.run_cell(cell, 3, 0.01, False, HostCard(torch))
