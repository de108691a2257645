"""The port's 256-shard graph dry run (``launch.graph_dryrun``) against
the reference's: the same graph, partition and plan (R, Hv, colors), the
same updates, and ``total_rank`` within 1e-4 relative (the reference's
XLA contracts a multiply and an add into an FMA where the port rounds
twice, ROADMAP caveat C2).  The reference runs in a subprocess: it
forces 512 host devices before importing JAX.
"""
import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import graph_dryrun

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--vertices", "2048", "--shards", "64", "--supersteps", "2"]


def _fields(text: str) -> dict:
    plan = re.search(r"plan: (\d+) shards, R=(\d+) rows/shard, Hv=(\d+), "
                     r"colors=(\d+)", text)
    edges = re.search(r"graph: (\d+) vertices, (\d+) edges", text)
    upd = re.search(r"supersteps on \d+ \w+ devices? in [\d.]+s \((\d+) "
                    r"updates\)|supersteps on \d+ shards \(\w+\) in [\d.]+s "
                    r"\((\d+) updates\)", text)
    total = re.search(r"sync total_rank = ([\d.]+)", text)
    assert plan and edges and upd and total, text
    return {"shards": int(plan[1]), "R": int(plan[2]), "Hv": int(plan[3]),
            "colors": int(plan[4]), "vertices": int(edges[1]),
            "edges": int(edges[2]),
            "updates": int(upd[1] or upd[2]), "total_rank": float(total[1]),
            "ok": "pod-scale graph-engine dry-run: OK" in text}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_run():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graph_dryrun.main(ARGS + ["--device", "cpu"])
    return buf.getvalue()


def test_graph_dry_run_equals_the_reference(port_run):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.graph_dryrun", *ARGS], env=env,
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-2000:]
    want, got = _fields(proc.stdout), _fields(port_run)
    assert want["ok"] and got["ok"]
    for key in ("shards", "R", "Hv", "colors", "vertices", "edges",
                "updates"):
        assert got[key] == want[key], key
    # the reference prints two decimals
    assert abs(got["total_rank"] - want["total_rank"]) <= max(
        1e-4 * want["total_rank"], 0.005)


def test_graph_dry_run_reports_each_superstep(port_run):
    steps = re.findall(r"superstep (\d+): (\d+) updates, [\d.]+ ms", port_run)
    assert [int(s) for s, _ in steps] == [1, 2]
    assert sum(int(u) for _, u in steps) == _fields(port_run)["updates"]
    assert "plan sizes: R " in port_run and "cut edges" in port_run


def test_graph_dry_run_equals_one_shard():
    """The 64-shard run is bitwise the one-shard run of the same
    supersteps in ranks and updates; ``total_rank`` merges 64 partial
    sums in shard order, so it is held to float32 rounding (1e-6)."""
    out = []
    for shards in (64, 1):
        eng, _, _ = graph_dryrun.build(2048, shards, 2, "cpu")
        res, updates, _ = graph_dryrun.run_supersteps(eng, 2)
        out.append((res["vertex_data"]["rank"], res["n_updates"], updates,
                    res["globals"]["total_rank"]))
    (r64, n64, u64, t64), (r1, n1, u1, t1) = out
    assert torch.equal(r64, r1)
    assert (n64, u64) == (n1, u1)
    assert abs(float(t64) - float(t1)) <= 1e-6 * abs(float(t1))


def test_web_graph_is_deterministic_and_simple():
    a, b = graph_dryrun.web_graph(500), graph_dryrun.web_graph(500)
    assert np.array_equal(a, b)
    assert (a[:, 0] < a[:, 1]).all()
    assert len(np.unique(a, axis=0)) == len(a)


def test_graph_dry_run_defaults_to_the_card():
    """No ``--device`` means the GPU: without one it raises, never a quiet
    CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph_dryrun.main(["--vertices", "64", "--shards", "2",
                           "--supersteps", "1"])
