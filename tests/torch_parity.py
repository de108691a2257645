"""Helpers for the tests that hold ``repro_torch`` against ``repro``:
export a reference graph as the numpy arrays ``repro_torch.interop``
reads, and the two graphs every engine-level parity test runs on."""
import jax
import numpy as np

from repro.core.graph import zipf_edges


def reference_arrays(g) -> tuple[dict, dict]:
    """``(arrays, meta)`` of a reference (JAX) ``DataGraph``, in the
    layout of ``repro_torch.interop.graph_to_arrays``."""
    host = np.asarray
    ell = g.ell
    arrays = {f"{f}.{b}": host(getattr(ell, f)[b])
              for f in ("nbrs", "nbr_mask", "edge_ids", "is_src")
              for b in range(ell.n_buckets)}
    arrays.update(perm=host(ell.perm), inv_perm=host(ell.inv_perm),
                  degree=host(g.degree), edges=g.edges_np,
                  edge_perm=g.edge_perm, edge_inv_perm=g.edge_inv_perm)
    if g.colors is not None:
        arrays["colors"] = host(g.colors)
    if ell.w_cap is not None:
        arrays.update(owner_of_vrow=host(ell.owner_of_vrow),
                      vrow_offset=host(ell.vrow_offset))
    arrays.update({f"vertex.{k}": host(v)
                   for k, v in jax.tree.map(host, g.vertex_data).items()})
    arrays.update({f"edge.{k}": host(v)
                   for k, v in jax.tree.map(host, g.edge_data).items()})
    meta = dict(n_vertices=g.n_vertices, n_edges=g.n_edges,
                max_deg=g.max_deg, widths=list(ell.widths),
                starts=list(ell.starts), pad_edge=ell.pad_edge,
                w_cap=ell.w_cap, n_chunks_max=ell.n_chunks_max,
                slack=g.slack)
    return arrays, meta


def quickstart_edges(n: int = 200) -> np.ndarray:
    """The preferential-attachment-ish graph of ``examples/quickstart.py``."""
    rng = np.random.default_rng(0)
    edges = set()
    for v in range(1, n):
        for _ in range(rng.integers(1, 4)):
            edges.add((int(rng.integers(0, v)), v))
    return np.asarray(sorted(edges))


# (name, n_vertices, edges, eps) of the engine-level parity graphs
ENGINE_GRAPHS = {
    "quickstart": (200, quickstart_edges, 1e-5),
    "zipf2000": (2000, lambda: zipf_edges(2000, alpha=2.0, max_deg=64,
                                          seed=1), 1e-4),
}


def reference_param_arrays(params) -> dict:
    """The reference's parameter pytree as the flat numpy arrays
    ``repro_torch.interop.params_from_arrays`` reads: keys are the
    dict paths joined by ``.``, stacked layers keep their ``[L, ...]``
    axis, and bfloat16 stays an ``ml_dtypes`` array."""
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {".".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in flat}


def reference_state_arrays(state) -> dict:
    """A reference ``ServeState`` as the flat numpy arrays
    ``repro_torch.interop.serve_state_from_arrays`` reads: ``cache_k``,
    ``cache_v``, ``cache_len``, ``mamba_state.<name>``, ``mem_k``,
    ``mem_v``; the parts the reference keeps as ``{}`` are left out."""
    out = {"cache_len": np.asarray(state.cache_len)}
    for name in ("cache_k", "cache_v", "mem_k", "mem_v"):
        part = getattr(state, name)
        if not isinstance(part, dict):
            out[name] = np.asarray(part)
    out.update({f"mamba_state.{k}": np.asarray(v)
                for k, v in state.mamba_state.items()})
    return out
