"""``als-netflix.chromatic`` on the CPU at 400 users x 60 movies: the
harness end to end, ``correct`` against the control and three planted
faults, no JAX, B3's work counted by hand, and the generator's triples.

The tiny configuration keeps the published law's shape (minimum, median
and maximum a side, every rating counted) at a size where each side's
maximum fits within the other side's count.
"""
import copy
import sys
import types

import numpy as np
import pytest
import torch

from bench import harness, roofline
from bench.control import readings
from bench.gen import netflix
from hostcard import HostCard
from test_bench_control import FAULTS

CELL = "als-netflix.chromatic"
CPU = torch.device("cpu")
TINY = dict(n_users=400, n_movies=60, n_ratings=4000,
            user_degrees={"minimum": 1, "median": 6, "maximum": 55},
            movie_degrees={"minimum": 3, "median": 40, "maximum": 380})


def tiny_cell(**traffic_run):
    cell = harness.load_cell(CELL)
    cell.config = dict(cell.config, **TINY)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["run"].update(traffic_run)
    return cell


def _run(cell, traced, seed=2 ** 31 + 13):
    return harness.run_cell(cell, seed, 0.05, traced, HostCard(torch))


def test_untraced_line():
    res = _run(tiny_cell(), False)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"job_s", "setup_s", "peak_mem_gib"}
    assert res["checks"]["updates_short"]["value"] == 0.0


def test_traced_line():
    res = _run(tiny_cell(), True)
    assert res["correct"] is True and res["attempted"] >= 4
    got = set(res["metrics"])
    # no device here: the device's idle share and busy time read nothing
    assert got == {"als_build_s", "als_superstep_ms", "als_gather_ms",
                   "als_reschedule_ms", "als_fold_ms", "als_solve_ms",
                   "als_normal_eq_roofline"}
    assert all(res["metrics"][k]["value"] > 0 for k in got)


def test_program_passes_and_control_fails():
    cell = tiny_cell()
    rows = []
    readings([cell], [21, 22], [21, 22, 23], HostCard(torch), rows.append)
    limit = {k: float(v["limit"]) for k, v in cell.limits.items()}
    for r in rows:
        over = [k for k, v in r["numbers"].items() if not v <= limit[k]]
        assert bool(over) == (r["kind"] == "control"), r


def _factor_unchanged(monkeypatch):
    from repro_torch.apps import als
    real = als.ridge_solve

    def kept(A, b, n_obs, w_old, X, lam):
        _, pred = real(A, b, n_obs, w_old, X, lam)
        return w_old, pred
    monkeypatch.setattr(als, "ridge_solve", kept)


def _half_the_ratings(monkeypatch):
    from repro_torch.core import exec as ex
    real = ex.gather_scopes

    def half(*a, **k):
        scope = real(*a, **k)
        odd = torch.arange(scope.nbr_mask.shape[1]) % 2 == 1
        scope.nbr_mask = scope.nbr_mask & ~odd
        return scope
    monkeypatch.setattr(ex, "gather_scopes", half)


@pytest.mark.parametrize("fault", [_factor_unchanged, _half_the_ratings,
                                   FAULTS["altered_answer"]])
def test_every_planted_fault_fails_every_answer(fault, monkeypatch):
    cell = tiny_cell()
    fault(monkeypatch)
    res = _run(cell, False, seed=31)
    assert res["correct"] is False
    assert res["failed"] == res["attempted"] >= 1


class _JudgeLoadsJax:
    def __init__(self, adapter):
        self._adapter = adapter

    def __getattr__(self, name):
        return getattr(self._adapter, name)

    def check(self, *args, **kwargs):
        sys.modules["jax"] = types.ModuleType("jax")
        return self._adapter.check(*args, **kwargs)


def test_jax_loaded_while_judging_gives_no_result(monkeypatch, capsys):
    from bench import card
    cell = tiny_cell()
    cell.adapter = _JudgeLoadsJax(cell.adapter)
    run = harness.load_module(harness.HERE / "run.py")
    monkeypatch.setattr(harness, "load_cell", lambda name: cell)
    monkeypatch.setattr(card, "CudaCard",
                        lambda torch_, chips: HostCard(torch_))
    had = sys.modules.pop("jax", None)
    try:
        rc = run.main(["--workload", CELL, "--seed", "5", "--seconds",
                       "0.01", "--trace", "0"])
    finally:
        sys.modules.pop("jax", None)
        if had is not None:
            sys.modules["jax"] = had
    out = capsys.readouterr()
    assert rc == 3 and out.out == "" and "jax" in out.err


def test_b3_work_of_a_hand_counted_graph():
    # users 0..2, movies 3..5: u0-m3, u0-m4, u1-m3, u2-m3, u2-m4, u2-m5
    metric = harness.load_module(harness.HERE / "metrics"
                                 / "als_normal_eq_roofline.py")
    cell = harness.load_cell(CELL)
    inputs = {"users": np.array([0, 0, 1, 2, 2, 2], np.int32),
              "movies": np.array([0, 1, 0, 0, 1, 2], np.int32)}
    ctx = harness.WorkContext(torch, CPU, dict(cell.config, n_users=3,
                                               n_movies=3, d=20),
                              cell.adapter, inputs)
    users = torch.tensor([0, 1, 2], dtype=torch.int32)
    b, f = metric.work((users, torch.tensor([True, True, True])), ctx)
    # 6 slots of 4d + 4 + 1 bytes, 3 outputs of 4 (d^2 + d); 6 (d(d+1) + 2d)
    assert (float(b), float(f)) == (6 * 85 + 3 * 4 * 420, 6 * 460)
    b, f = metric.work((users, torch.tensor([True, False, True])), ctx)
    assert (float(b), float(f)) == (5 * 85 + 2 * 1680, 5 * 460)
    movies = torch.tensor([3, 4, 5, 3], dtype=torch.int32)    # 3 repeated
    b, f = metric.work((movies, torch.tensor([True, True, True, False])),
                       ctx)
    assert (float(b), float(f)) == (6 * 85 + 3 * 1680, 6 * 460)
    assert roofline.least_seconds(b, f) == float(b) / roofline.HBM_BYTES_PER_S


@pytest.mark.parametrize("seed", [1, 2, 2 ** 40 + 3])
def test_generator_triples(seed):
    cfg = dict(harness.load_cell(CELL).config, **TINY)
    t = netflix.netflix(torch, cfg, seed, CPU)
    u, m = t["users"], t["movies"]
    assert u.shape == m.shape == t["ratings"].shape == (cfg["n_ratings"],)
    key = u * cfg["n_movies"] + m
    assert torch.equal(key, torch.unique(key))      # sorted, none twice
    _, law = netflix.degrees(torch, cfg, CPU)
    assert torch.equal(torch.bincount(m, minlength=cfg["n_movies"]), law)
    # every user rated something, whatever the race left it
    assert int(torch.bincount(u, minlength=cfg["n_users"]).min()) >= 1
    assert t["w0"].shape == (cfg["n_users"] + cfg["n_movies"], cfg["d"])
    again = netflix.netflix(torch, cfg, seed, CPU)
    assert all(torch.equal(t[k], again[k]) for k in t)
    other = netflix.netflix(torch, cfg, seed + 1, CPU)
    assert not torch.equal(t["ratings"], other["ratings"])
