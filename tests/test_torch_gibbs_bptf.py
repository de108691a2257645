"""The port's Gibbs sampler and BPTF against the reference's.

Gibbs: the threefry-2x32 hash, ``PRNGKey``, ``split`` and ``uniform``
written in torch integer ops are held bitwise to ``jax.random`` (the
installed JAX's partitionable threefry), keys, uniforms and counters
bitwise through a sweep.  The spins cannot be bitwise: ``jax.nn.sigmoid``
and ``torch.sigmoid`` round a few inputs in a million one ulp apart, so a
draw may flip where ``|u - p| <= 1e-6``; they are held equal everywhere
else, and the sampler to the exact marginals within 0.05 (the
reference's statistical gate).

BPTF: the graph is bitwise the reference's; the normal equations of a
scope (through ``als_normal_eq``) are within rtol = atol = 1e-5 of the
reference's einsums; the time-table sync is bitwise (one-hot adds of
zeros, halving tree); a run is within 1e-4 of the reference's and
reaches its convergence gate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from repro.apps import bptf as ref_bptf
from repro.apps import gibbs as ref_gibbs
from repro.core import ChromaticEngine as RefChromatic
from repro.core.update import gather_scopes as ref_gather_scopes
from repro_torch import api, interop
from repro_torch.apps import BUILDERS, bptf, gibbs
from repro_torch.core.update import gather_scopes
from repro_torch.kernels.als_normal_eq import als_normal_eq_fold
from torch_parity import reference_arrays

CYCLE = np.asarray([[0, 1], [1, 2], [2, 3], [3, 0]])


def _keys(n, seed=0):
    """uint32 key pairs with the corners: all bits, none, the high bit."""
    k = np.random.default_rng(seed).integers(0, 2 ** 32, (n, 2),
                                             dtype=np.uint64)
    k = k.astype(np.uint32)
    k[:6] = [[0xFFFFFFFF, 0xFFFFFFFF], [0, 0], [0x80000000, 1],
             [1, 0x80000000], [0xDEADBEEF, 0xCAFEBABE], [0x7FFFFFFF, 0]]
    return k


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_reference_uses_the_partitionable_threefry():
    """The port hard-codes the partitionable variant (the GPU host has no
    JAX to ask); this pins the installed reference to it."""
    assert jax.config.jax_threefry_partitionable


def test_threefry2x32_matches_jax_bitwise():
    k = _keys(64)
    x = _keys(512, seed=1)
    for i in range(0, 64, 8):
        want = np.asarray(jax_prng.threefry_2x32(
            (jnp.uint32(k[i, 0]), jnp.uint32(k[i, 1])),
            jnp.asarray(np.concatenate([x[:, 0], x[:, 1]]))))
        t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
        o1, o2 = gibbs.threefry2x32(t(k[i, 0]), t(k[i, 1]), t(x[:, 0]),
                                    t(x[:, 1]))
        np.testing.assert_array_equal(
            np.concatenate([_u32(o1), _u32(o2)]), want)


def test_prng_key_split_and_uniform_match_jax_bitwise():
    k = _keys(2000)

    def ref(kk):
        key = jax.random.wrap_key_data(kk)
        a, b = jax.random.split(key)
        return (jax.random.key_data(a), jax.random.key_data(b),
                jax.random.uniform(b), jax.random.uniform(key))
    A, B, U, U0 = (np.asarray(v) for v in jax.vmap(ref)(jnp.asarray(k)))
    tk = torch.from_numpy(k.astype(np.int64))
    a, b = gibbs.split(tk)
    np.testing.assert_array_equal(_u32(a), A)
    np.testing.assert_array_equal(_u32(b), B)
    for got, want in ((gibbs.uniform(b), U), (gibbs.uniform(tk), U0)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
    seeds = np.concatenate([np.arange(0, 50_000, 97),
                            [2 ** 31 - 1, 1000003 * 7]])
    want = jax.vmap(lambda s: jax.random.key_data(jax.random.PRNGKey(s)))(
        jnp.asarray(seeds, jnp.int32))
    np.testing.assert_array_equal(_u32(gibbs.prng_key(seeds)),
                                  np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_ising_problem_matches_reference(seed):
    """Spins, keys (widened to int64 by ``interop``), counters and
    colors are the reference's."""
    edges = np.asarray([[0, 1], [1, 2], [2, 3], [3, 0], [0, 4], [4, 5]])
    want = ref_gibbs.ising_problem(edges, 6, beta=0.35, field=0.2,
                                   seed=seed)
    got = gibbs.ising_problem(edges, 6, beta=0.35, field=0.2, seed=seed,
                              device="cpu")
    ref_arrays, ref_meta = reference_arrays(want.graph)
    arrays, meta = interop.graph_to_arrays(got.graph)
    assert meta == ref_meta and set(arrays) == set(ref_arrays)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], ref_arrays[k], err_msg=k)
    assert got.graph.vertex_data["key"].dtype == torch.int64
    carried = interop.graph_from_arrays(ref_arrays, ref_meta, device="cpu")
    assert torch.equal(carried.vertex_data["key"],
                       got.graph.vertex_data["key"])


def test_one_sweep_matches_reference_where_the_draw_is_clear():
    """One chromatic sweep from identical state on a 3-D grid: keys,
    sweep counters and the draws' uniforms bitwise; spins equal wherever
    ``|u - p| > 1e-6`` (p in float64)."""
    from repro_torch.core.graph import grid_edges_3d
    n, edges = grid_edges_3d(6, 7, 8)
    beta, field = 0.35, 0.2
    want_p = ref_gibbs.ising_problem(edges, n, beta, field, seed=3)
    port = interop.graph_from_arrays(*reference_arrays(want_p.graph),
                                     device="cpu")
    want = RefChromatic(want_p.graph, ref_gibbs.make_update(beta, field),
                        max_supersteps=1).run(num_supersteps=1)
    got = api.run(port, gibbs.make_update(beta, field), scheduler="chromatic",
                  num_supersteps=1, device="cpu")
    np.testing.assert_array_equal(_u32(got.vertex_data["key"]),
                                  np.asarray(want.vertex_data["key"]))
    np.testing.assert_array_equal(got.vertex_data["sweep"].numpy(),
                                  np.asarray(want.vertex_data["sweep"]))
    # the draw of each vertex: uniform(split(key0)[1]) against p
    key0 = port.vertex_data["key"]
    u = gibbs.uniform(gibbs.split(key0)[1]).numpy().astype(np.float64)
    # p from the spins each vertex saw: colors in order, so color-0
    # vertices saw the initial spins and color-1 vertices the new ones
    colors = port.colors.numpy()
    spin0 = port.vertex_data["spin"].numpy()
    spin1 = got.vertex_data["spin"].numpy()
    seen = np.zeros(n)
    for c in range(port.n_colors):
        cur = np.where(colors < c, spin1, spin0).astype(np.float64)
        s = np.zeros(n)
        np.add.at(s, edges[:, 0], 2 * cur[edges[:, 1]] - 1)
        np.add.at(s, edges[:, 1], 2 * cur[edges[:, 0]] - 1)
        seen = np.where(colors == c, s, seen)
    p = 1.0 / (1.0 + np.exp(-2.0 * (beta * seen + field)))
    clear = np.abs(u - p) > 1e-6
    assert clear.mean() > 0.99
    want_spin = np.asarray(want.vertex_data["spin"])
    np.testing.assert_array_equal(spin1[clear], want_spin[clear])
    np.testing.assert_array_equal(spin1[clear], (u < p)[clear])


def test_gibbs_matches_exact_ising_marginals():
    """The mirror of tests/test_apps.py: chromatic Gibbs on a 4-cycle
    within 0.05 of the exact marginals."""
    prob = gibbs.ising_problem(CYCLE, 4, beta=0.35, field=0.2, seed=1,
                               device="cpu")
    g, upd, syncs = gibbs.build(prob, burn_in=100)
    st = api.run(g, upd, syncs=syncs, scheduler="chromatic",
                 max_supersteps=4000, device="cpu")
    assert st.superstep == 4000
    emp = gibbs.marginals(st.vertex_data)
    exact = gibbs.exact_marginals(CYCLE, 4, 0.35, field=0.2)
    np.testing.assert_allclose(
        exact, ref_gibbs.exact_marginals(CYCLE, 4, 0.35, field=0.2))
    np.testing.assert_allclose(emp, exact, atol=0.05)
    with pytest.raises(ValueError, match="> 16"):
        gibbs.exact_marginals(CYCLE, 17, 0.35)


# ----------------------------------------------------------------------
# BPTF
# ----------------------------------------------------------------------

BPTF_ARGS = dict(n_users=30, n_movies=25, n_times=5, d=4, density=0.3,
                 noise=0.05)


@pytest.fixture(scope="module")
def bptf_pair():
    return (ref_bptf.synthetic_bptf(**BPTF_ARGS),
            bptf.synthetic_bptf(**BPTF_ARGS, device="cpu"))


def test_bptf_problem_matches_reference(bptf_pair):
    want, got = bptf_pair
    ref_arrays, ref_meta = reference_arrays(want.graph)
    arrays, meta = interop.graph_to_arrays(got.graph)
    assert meta == ref_meta and set(arrays) == set(ref_arrays)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], ref_arrays[k], err_msg=k)
    np.testing.assert_array_equal(got.ratings, want.ratings)
    np.testing.assert_array_equal(got.triples, want.triples)


def test_bptf_normal_equations_match_reference_einsums(bptf_pair):
    """``(A, b)`` of a batch of scopes through ``als_normal_eq_fold``
    against the reference update's two einsums on the same scopes."""
    want_p, got_p = bptf_pair
    rng = np.random.default_rng(0)
    w = rng.normal(size=(got_p.graph.n_vertices, 4)).astype(np.float32)
    table = (1.0 + 0.1 * rng.normal(size=(5, 4))).astype(np.float32)
    ids = np.arange(got_p.graph.n_vertices, dtype=np.int32)
    vd = dict(got_p.graph.vertex_data, w=torch.from_numpy(w))
    scope = gather_scopes(got_p.graph, vd, got_p.graph.edge_data,
                          torch.from_numpy(ids),
                          {"time_factors": torch.from_numpy(table)})
    X = scope.nbr_data["w"] * torch.from_numpy(table)[
        scope.edge_data["time"].long()]
    A, b = als_normal_eq_fold(scope.nbr_mask,
                              scope.edge_data["rating"].contiguous(), X)
    rvd = dict(want_p.graph.vertex_data, w=jnp.asarray(w))
    rs = ref_gather_scopes(want_p.graph, rvd, want_p.graph.edge_data,
                           jnp.asarray(ids), {})
    Xr = rs.nbr_data["w"] * jnp.asarray(table)[
        rs.edge_data["time"].astype(jnp.int32)]
    m = rs.nbr_mask.astype(jnp.float32)
    Xm = Xr * m[..., None]
    Ar = jnp.einsum("bdi,bdj->bij", Xm, Xm)
    br = jnp.einsum("bdi,bd->bi", Xm, rs.edge_data["rating"] * m)
    np.testing.assert_allclose(A.numpy(), np.asarray(Ar), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(br), rtol=1e-5,
                               atol=1e-5)


def test_bptf_time_table_sync_matches_reference_bitwise(bptf_pair):
    want_p, got_p = bptf_pair
    w = np.random.default_rng(1).normal(
        size=(got_p.graph.n_vertices, 4)).astype(np.float32)
    want = ref_bptf.time_table_sync(5, 4).run(
        dict(want_p.graph.vertex_data, w=jnp.asarray(w)))
    got = bptf.time_table_sync(5, 4).run(
        dict(got_p.graph.vertex_data, w=torch.from_numpy(w)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), w[-5:])


def test_bptf_tripartite_converges(bptf_pair):
    """The mirror of tests/test_extras.py: 30 chromatic supersteps reach
    RMSE < 0.25 x the ratings' RMS; factors within 1e-4 and the RMSE
    within 1e-5 of the reference's run."""
    want_p, got_p = bptf_pair
    g, upd, syncs = BUILDERS["bptf"](got_p, lam=0.02)
    st = api.run(g, upd, syncs=syncs, scheduler="chromatic",
                 num_supersteps=30, device="cpu")
    rmse = bptf.dataset_rmse(got_p, st.vertex_data, st.globals)
    base = float(np.sqrt(np.mean(got_p.ratings ** 2)))
    assert rmse < 0.25 * base, (rmse, base)
    want = RefChromatic(want_p.graph, ref_bptf.make_update(4, lam=0.02),
                        syncs=[ref_bptf.time_table_sync(5, 4)],
                        max_supersteps=30).run(num_supersteps=30)
    np.testing.assert_allclose(st.vertex_data["w"].numpy(),
                               np.asarray(want.vertex_data["w"]),
                               rtol=0, atol=1e-4)
    assert abs(rmse - ref_bptf.dataset_rmse(want_p, want.vertex_data,
                                            want.globals)) < 1e-5


def test_bptf_bulk_problem_shares_the_assembly(bptf_pair):
    """``problem_from_triples`` with the 2-coloring builds the generator's
    graph (storage and data bitwise) under a proper 2-coloring."""
    from repro_torch.core.coloring import verify_coloring
    _, want = bptf_pair
    nu, nm, nt = 30, 25, 5
    tri = want.triples
    w0 = want.graph.vertex_data["w"].numpy()
    got = bptf.problem_from_triples(
        nu, nm, nt, 4, tri[:, 0], tri[:, 1], tri[:, 2], want.ratings, w0,
        colors=bptf.tripartite_coloring(nu, nm, nt), device="cpu")
    assert got.graph.n_colors == 2
    assert verify_coloring(got.graph.n_vertices, got.graph.edges_np,
                           got.graph.colors.numpy())
    a, meta = interop.graph_to_arrays(got.graph)
    b, want_meta = interop.graph_to_arrays(want.graph)
    assert meta == want_meta
    for k in a:
        if k != "colors":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
