"""The port's CC, CoEM and CoSeg LBP against the reference's.

Problems are generated by both packages from the same seed (their
generators make the same draws, so the graphs are bitwise equal) and
carried across with ``interop.graph_from_arrays``.  CC is exact.  CoEM
is held to ``rtol = atol = 1e-5``: its mix runs through ``ell_spmv`` at
F = n_types, where the reference's interpret mode differs by an ulp
(ROADMAP C6), and its normalization sums in another order.  LBP is held
to 1e-5 on chromatic and to outcome bands on the adaptive schedulers:
``torch.logsumexp`` and ``jax.nn.logsumexp`` differ by ulps, and a
near-tie of residuals can reorder a priority schedule.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.apps import cc as ref_cc
from repro.apps import coem as ref_coem
from repro.apps import lbp as ref_lbp
from repro.core.graph import zipf_edges
from repro_torch import api, interop
from repro_torch.apps import cc, coem, lbp
from repro_torch.core.coloring import greedy_coloring
from repro_torch.core.graph import DataGraph
from conftest import random_graph
from torch_parity import reference_arrays

ROOT = Path(__file__).resolve().parents[1]


def _same_storage(ref_graph, port_graph):
    want, want_meta = reference_arrays(ref_graph)
    got, got_meta = interop.graph_to_arrays(port_graph)
    assert got_meta == want_meta and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ----------------------------------------------------------------------
# Connected components
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_components_matches_reference(seed):
    n = 300
    edges = zipf_edges(n, alpha=2.2, max_deg=12, seed=seed)
    labels = np.random.default_rng(seed).permutation(n).astype(np.int32)
    for lab in (None, labels):
        np.testing.assert_array_equal(
            cc.reference_components(edges, n, lab),
            ref_cc.reference_components(edges, n, lab))


@pytest.mark.parametrize("scheduler,opts", [
    ("chromatic", {}), ("bsp", {}), ("priority", {"k_select": 8}),
    ("priority", {"k_select": 8, "fifo": True}),
    ("locking", {"max_pending": 8})])
def test_cc_reaches_the_union_find_labels(scheduler, opts):
    """Every scheduler reaches the per-component least label, with
    injected labels too, and the graph builds as the reference's."""
    n = 120
    edges = random_graph(n, 110, seed=4)
    labels = np.random.default_rng(1).permutation(n).astype(np.int32)
    g, upd, syncs = cc.build(edges, n, labels=labels, device="cpu")
    _same_storage(ref_cc.build(edges, n, labels=labels)[0], g)
    res = api.run(g, upd, syncs=syncs, scheduler=scheduler, device="cpu",
                  **opts)
    assert not res.active_any
    np.testing.assert_array_equal(res.vertex_data["label"].numpy(),
                                  cc.reference_components(edges, n, labels))


# ----------------------------------------------------------------------
# CoEM
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ner():
    """A 200-vertex NER corpus from both generators, and the reference's
    chromatic (converged) and priority (120 supersteps) runs."""
    kw = dict(mean_deg=8, seed_frac=0.15, seed=1)
    ref_prob = ref_coem.synthetic_ner(120, 80, 3, **kw)
    prob = coem.synthetic_ner(120, 80, 3, device="cpu", **kw)
    g, upd, syncs = ref_coem.build(ref_prob, eps=1e-4)
    runs = {"chromatic": ref_api.run(g, upd, syncs=syncs,
                                     max_supersteps=50),
            "priority": ref_api.run(g, upd, syncs=syncs,
                                    scheduler="priority", k_select=32,
                                    num_supersteps=120)}
    return dict(ref=ref_prob, port=prob, runs=runs)


def test_synthetic_ner_is_the_reference_corpus(ner):
    _same_storage(ner["ref"].graph, ner["port"].graph)
    np.testing.assert_array_equal(ner["port"].true_types,
                                  ner["ref"].true_types)


@pytest.mark.parametrize("scheduler", ["chromatic", "priority"])
def test_coem_matches_reference(ner, scheduler):
    """Tables within 1e-5 of the reference's, the same counts, the
    entropy sync within 1e-5, the planted types recovered; the kernel
    and dense arms bitwise equal under both launch shapes."""
    g, upd, syncs = coem.build(ner["port"], eps=1e-4)
    kw = ({"max_supersteps": 50} if scheduler == "chromatic"
          else {"k_select": 32, "num_supersteps": 120})
    want = ner["runs"][scheduler]
    outs = {(d, k): api.run(g, upd, syncs=syncs, scheduler=scheduler,
                            dispatch=d, use_kernel=k, device="cpu", **kw)
            for d in ("bucket", "batch") for k in (True, False)}
    got = outs["bucket", True]
    for key, st in outs.items():
        assert torch.equal(st.vertex_data["p"], got.vertex_data["p"]), key
        assert (st.superstep, st.n_updates) == (got.superstep,
                                                got.n_updates), key
    assert (got.superstep, got.n_updates) == (int(want.superstep),
                                              int(want.n_updates))
    np.testing.assert_allclose(got.vertex_data["p"].numpy(),
                               np.asarray(want.vertex_data["p"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.globals["entropy"]),
                               float(want.globals["entropy"]),
                               rtol=1e-5, atol=1e-5)
    acc = coem.label_accuracy(ner["port"], got.vertex_data)
    assert acc == ref_coem.label_accuracy(ner["ref"], want.vertex_data)
    assert acc > 0.8, f"CoEM should recover planted types, got {acc}"


# ----------------------------------------------------------------------
# CoSeg LBP
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def coseg():
    """A 3 x 4 x 8 CoSeg problem from both generators (carried across to
    the port), its unary-only accuracy, and the reference's runs: 5
    chromatic supersteps with the GMM sync, and priority and locking to
    convergence without it (its ``test_apps.py`` case)."""
    ref_prob = ref_lbp.synthetic_coseg(3, 4, 8, n_labels=3, noise=0.6)
    prob = lbp.synthetic_coseg(3, 4, 8, n_labels=3, noise=0.6, device="cpu")
    g, upd, syncs = ref_lbp.build(ref_prob, beta=0.5, eps=1e-3)
    plain = ref_lbp.make_update(3, beta=0.5, eps=1e-3)
    runs = {"chromatic": ref_api.run(g, upd, syncs=syncs, num_supersteps=5),
            "priority": ref_api.run(g, plain, scheduler="priority",
                                    k_select=32, max_supersteps=3000),
            "locking": ref_api.run(g, plain, scheduler="locking",
                                   max_pending=32, max_supersteps=3000)}
    base = float((np.asarray(ref_prob.graph.vertex_data["unary"]).argmax(1)
                  == ref_prob.true_labels).mean())
    return dict(ref=ref_prob, port=prob, runs=runs, base=base)


def test_synthetic_coseg_is_the_reference_problem(coseg):
    _same_storage(coseg["ref"].graph, coseg["port"].graph)
    np.testing.assert_array_equal(coseg["port"].true_labels,
                                  coseg["ref"].true_labels)


def test_lbp_chromatic_matches_reference(coseg):
    """After 5 chromatic supersteps with the GMM sync: beliefs, both
    messages of every edge and the centroids within 1e-5.  (The pad
    edge row is left out: the reference parks masked-off edge writes
    there, the port drops them.)"""
    g, upd, syncs = lbp.build(coseg["port"], beta=0.5, eps=1e-3)
    got = api.run(g, upd, syncs=syncs, num_supersteps=5, device="cpu")
    want = coseg["runs"]["chromatic"]
    assert got.n_updates == int(want.n_updates)
    np.testing.assert_allclose(got.vertex_data["belief"].numpy(),
                               np.asarray(want.vertex_data["belief"]),
                               rtol=1e-5, atol=1e-5)
    for k in ("msg01", "msg10"):
        np.testing.assert_allclose(got.edge_data[k][:-1].numpy(),
                                   np.asarray(want.edge_data[k])[:-1],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got.globals["gmm"].numpy(),
                               np.asarray(want.globals["gmm"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scheduler,opts", [
    ("priority", {"k_select": 32}), ("locking", {"max_pending": 32})])
def test_lbp_adaptive_schedules_match_reference_outcome(coseg, scheduler,
                                                        opts):
    """Residual BP under priority and locking (the twin of the
    reference's ``test_coseg_priority_engine_improves_over_unary``):
    drained, accuracy within 0.02 of the reference's and no worse than
    the unary potentials alone, under both launch shapes."""
    upd = lbp.make_update(3, beta=0.5, eps=1e-3)
    want = ref_lbp.label_accuracy(coseg["ref"],
                                  coseg["runs"][scheduler].vertex_data)
    for dispatch in ("bucket", "batch"):
        got = api.run(coseg["port"].graph, upd, scheduler=scheduler,
                      dispatch=dispatch, max_supersteps=3000, device="cpu",
                      **opts)
        assert not got.active_any
        acc = lbp.label_accuracy(coseg["port"], got.vertex_data)
        assert abs(acc - want) <= 0.02, (dispatch, acc, want)
        assert acc >= coseg["base"], f"LBP smoothing hurt: {acc}"


def test_lbp_residual_locking_engine(coseg):
    eng = lbp.residual_locking_engine(coseg["port"], eps=1e-3, max_pending=16)
    st = eng.run(num_supersteps=3)
    assert eng.max_pending == 16 and st.superstep == 3
    assert torch.isfinite(st.vertex_data["belief"]).all()
    assert "gmm" in st.globals


def test_lbp_on_tree_matches_exact_marginals():
    """Sum-product BP is exact on trees: a chain of 4 vertices, on the
    chromatic and the locking engine."""
    k = 3
    edges = np.asarray([[0, 1], [1, 2], [2, 3]])
    rng = np.random.default_rng(0)
    unary = rng.normal(size=(4, k)).astype(np.float32)
    g = DataGraph.from_edges(
        4, edges,
        vertex_data={"feat": np.zeros((4, 1), np.float32),
                     "unary": unary, "belief": unary.copy()},
        edge_data={"msg01": np.zeros((3, k), np.float32),
                   "msg10": np.zeros((3, k), np.float32)}, device="cpu")
    g = g.with_colors(greedy_coloring(4, edges))
    beta = 0.7
    upd = lbp.make_update(k, beta=beta, eps=1e-7, use_gmm_sync=False)
    psi = np.exp(-beta * (1 - np.eye(k)))
    pot = np.exp(unary.astype(np.float64))
    joint = np.einsum("a,b,c,d,ab,bc,cd->abcd", pot[0], pot[1], pot[2],
                      pot[3], psi, psi, psi)
    joint /= joint.sum()
    for scheduler, opts in (("chromatic", {}), ("locking",
                                                {"max_pending": 2})):
        st = api.run(g, upd, scheduler=scheduler, max_supersteps=50,
                     device="cpu", **opts)
        beliefs = torch.softmax(st.vertex_data["belief"].double(), -1)
        for v, axes in enumerate([(1, 2, 3), (0, 2, 3), (0, 1, 3),
                                  (0, 1, 2)]):
            np.testing.assert_allclose(beliefs[v].numpy(),
                                       joint.sum(axis=axes), atol=1e-3)


def test_gmm_sync_matches_reference(coseg):
    """The GMM M-step sync on the same beliefs: within 1e-5."""
    rng = np.random.default_rng(2)
    vd = {"belief": rng.normal(size=(96, 3)).astype(np.float32),
          "feat": rng.normal(size=(96, 3)).astype(np.float32)}
    want = ref_lbp.gmm_sync(3, 3).run(jax.tree.map(jnp.asarray, vd))
    got = lbp.gmm_sync(3, 3).run({k: torch.from_numpy(v)
                                  for k, v in vd.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_coseg_example_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "coseg_priority_torch.py"),
         "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "locking" in proc.stdout and "priority" in proc.stdout
