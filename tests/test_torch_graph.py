"""Graph storage of the port against the reference, bitwise: sliced-ELL
blocks, permutations, edge renumbering, degrees, greedy colors and
PageRank weights; plus the package's import isolation and device rule."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_graph
from repro.apps import pagerank as ref_pagerank
from repro.core import coloring as ref_coloring
from repro.core import graph as ref_graph
from repro_torch import interop, resolve_device
from repro_torch.apps import pagerank
from repro_torch.core import coloring, graph
from torch_parity import reference_arrays

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

GRAPHS = {
    "random60": lambda: (60, random_graph(60, 150, seed=3)),
    "random200": lambda: (200, random_graph(200, 700, seed=0)),
    "zipf300": lambda: (300, ref_graph.zipf_edges(300, alpha=2.0,
                                                  max_deg=32, seed=2)),
    "zipf2000": lambda: (2000, ref_graph.zipf_edges(2000, alpha=2.0,
                                                    max_deg=64, seed=1)),
}


def _edge_data(n_edges):
    rng = np.random.default_rng(n_edges)
    return {"w": rng.random(n_edges).astype(np.float32),
            "k": rng.integers(0, 9, (n_edges, 3)).astype(np.int32)}


def _both(name, edge_locality):
    n, edges = GRAPHS[name]()
    vdata = {"rank": np.arange(n, dtype=np.float32)}
    edata = _edge_data(len(edges))
    ref = ref_graph.DataGraph.from_edges(n, edges, vdata, edata,
                                         edge_locality=edge_locality)
    port = graph.DataGraph.from_edges(n, edges, vdata, edata,
                                      edge_locality=edge_locality,
                                      device="cpu")
    return n, edges, ref, port


@pytest.mark.parametrize("edge_locality", [True, False])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_storage_bitwise(name, edge_locality):
    n, edges, ref, port = _both(name, edge_locality)
    want, want_meta = reference_arrays(ref)
    got, got_meta = interop.graph_to_arrays(port)
    assert got_meta == want_meta
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    for rp, pp in zip(ref.to_padded(), port.to_padded()):
        np.testing.assert_array_equal(pp.numpy(), np.asarray(rp))
    assert port.ell.padded_slots == ref.ell.padded_slots
    assert port.ell.bucket_launches == ref.ell.bucket_launches


@pytest.mark.parametrize("name", ["random200", "zipf2000"])
def test_rows_and_activation_match_reference(name):
    n, edges, ref, port = _both(name, True)
    rng = np.random.default_rng(1)
    ids = rng.choice(n, size=min(n, 96), replace=False).astype(np.int32)
    sel = rng.random(len(ids)) < 0.7
    for width in (None, 3, 8):
        want = ref.ell.rows(jnp.asarray(ids), width=width)
        got = port.ell.rows(torch.from_numpy(ids), width=width)
        for w_, g_ in zip(want, got):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    np.testing.assert_array_equal(
        port.ell.row_activation(torch.from_numpy(ids),
                                torch.from_numpy(sel)).numpy(),
        np.asarray(ref.ell.row_activation(jnp.asarray(ids),
                                          jnp.asarray(sel))))


@pytest.mark.parametrize("name", ["random60", "zipf2000"])
def test_flat_and_bucket_gathers_match_reference(name, monkeypatch):
    """A window-sized batch gathers through the flat stores, a large one
    bucket by bucket: both give the reference's rows at every scope
    width, with rows wider than the width reading as empty and the
    out-of-range position as padding; the bucket blocks are aligned
    views of the flat stores."""
    n, edges, ref, port = _both(name, True)
    ell = port.ell
    rng = np.random.default_rng(2)
    ids = rng.choice(n, size=min(n, 200), replace=False).astype(np.int32)
    pos = torch.cat([ell.inv_perm[torch.from_numpy(ids).long()],
                     torch.tensor([ell.total_rows], dtype=torch.int32)])
    for width in (None,) + ell.scope_widths + (1, 5):
        want = ref.ell.rows(jnp.asarray(ids), width=width)
        d = ell.max_deg if width is None else ell.snap_width(width)
        flat = ell._flat_rows(pos, d)
        bucket = ell._bucket_rows(pos, d)
        for f_, b_, w_ in zip(flat, bucket, want):
            assert torch.equal(f_, b_)
            np.testing.assert_array_equal(f_[:-1].numpy(), np.asarray(w_))
        assert not flat.nbr_mask[-1].any() and not flat.is_src[-1].any()
        assert (flat.edge_ids[-1] == ell.pad_edge).all()
        assert (flat.nbrs[-1] == 0).all()
    monkeypatch.setattr(graph, "FLAT_GATHER_SLOTS", 0)
    got = ell.rows(torch.from_numpy(ids), width=8)
    for g_, w_ in zip(got, ref.ell.rows(jnp.asarray(ids), width=8)):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    for blocks, flat in zip((ell.nbrs, ell.nbr_mask, ell.edge_ids,
                             ell.is_src), ell.slots):
        for blk in blocks:
            off = blk.data_ptr() - flat.data_ptr()
            assert blk.is_contiguous()
            assert blk.untyped_storage().data_ptr() == flat.data_ptr()
            assert off % (graph.SLOT_ALIGN * flat.element_size()) == 0


def test_interop_carries_reference_graph_across():
    n, edges = GRAPHS["zipf300"]()
    ref, _, _ = ref_pagerank.build(edges, n)
    port = interop.graph_from_arrays(*reference_arrays(ref), device="cpu")
    again, _ = interop.graph_to_arrays(port)
    want, _ = reference_arrays(ref)
    for k in want:
        np.testing.assert_array_equal(again[k], want[k], err_msg=k)
    assert port.n_colors == ref.n_colors


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_greedy_coloring_matches_reference(name):
    n, edges = GRAPHS[name]()
    got = coloring.greedy_coloring(n, edges)
    np.testing.assert_array_equal(got, ref_coloring.greedy_coloring(n, edges))
    assert coloring.verify_coloring(n, edges, got)
    assert coloring.verify_coloring(n, edges, got, distance=2) == \
        ref_coloring.verify_coloring(n, edges, got, distance=2)
    bad = got.copy()
    u, v = edges[0]
    bad[v] = bad[u]
    assert not coloring.verify_coloring(n, edges, bad)


def test_coloring_with_self_loops_and_duplicates():
    edges = np.asarray([[0, 0], [0, 1], [0, 1], [1, 2], [2, 3], [3, 3]])
    np.testing.assert_array_equal(
        coloring.greedy_coloring(5, edges),
        ref_coloring.greedy_coloring(5, edges))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pagerank_weights_bitwise(name):
    n, edges = GRAPHS[name]()
    ref = ref_pagerank.make_graph(edges, n)
    port = pagerank.make_graph(edges, n, device="cpu")
    np.testing.assert_array_equal(port.edge_data["w"].numpy(),
                                  np.asarray(ref.edge_data["w"]))
    np.testing.assert_array_equal(port.colors.numpy(), np.asarray(ref.colors))
    assert port.n_colors == ref.n_colors


def test_generators_match_reference():
    for args in [(500, 2.0, None, 0), (3000, 1.7, 40, 5)]:
        np.testing.assert_array_equal(graph.zipf_edges(*args),
                                      ref_graph.zipf_edges(*args))
    for dims in [(3, 4, 5), (1, 2, 3), (2, 1, 1)]:
        want = ref_graph.grid_edges_3d(*dims)
        got = graph.grid_edges_3d(*dims)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1].reshape(-1, 2))
    pairs = np.asarray([[0, 1], [2, 0], [1, 1]])
    want = ref_graph.bipartite_edges(3, 2, pairs)
    got = graph.bipartite_edges(3, 2, pairs)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("kwargs,error,match", [
    ({"hub_split": True, "bucket_widths": (2, 4)}, ValueError,
     "bucket_widths"),
    ({"w_cap": 6}, ValueError, "power of two"),
    ({"width_policy": "measured"}, NotImplementedError, "A8"),
    ({"slack": 2}, NotImplementedError, "A11")])
def test_unported_storage_options_raise(kwargs, error, match):
    """Hub splitting is ported: its illegal values and combinations raise
    the reference's ValueErrors.  Measured width plans (A8) and slack
    (A11) are not ported and say which ROADMAP item they wait for."""
    edges = random_graph(20, 40)
    with pytest.raises(error, match=match):
        graph.DataGraph.from_edges(20, edges, {"x": np.zeros(20)},
                                   device="cpu", **kwargs)


def test_entry_points_raise_without_gpu(monkeypatch):
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.serve import engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    edges = random_graph(20, 40)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pagerank.build(edges, 20)
    cfg = configs.get("qwen3-4b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.params_from_arrays({}, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-4b"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_package_imports_neither_jax_nor_repro():
    """No module of the port -- every subpackage, the LLM stack's
    ``configs``, ``models``, ``serve`` and ``launch`` included -- nor
    ``chip_smoke.py`` imports JAX, the reference or ``ml_dtypes``."""
    banned = ("jax", "jaxlib", "repro", "ml_dtypes")
    paths = [*PKG.rglob("*.py"), PKG.parents[1] / "chip_smoke.py"]
    subpackages = {p.relative_to(PKG).parts[0] for p in paths
                   if p.parent != PKG and PKG in p.parents}
    assert {"configs", "models", "serve", "launch", "kernels"} <= subpackages
    for path in paths:
        for line in path.read_text().splitlines():
            line = line.strip()
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod not in banned, f"{path.name}: {line}"
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    assert "repro_torch.launch.serve" in mods
    code = ("import sys\n"
            f"for m in {banned!r}: sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"assert not any(k.split('.')[0] in {banned!r} and "
            "sys.modules[k] is not None for k in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
