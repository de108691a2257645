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


# ----------------------------------------------------------------------
# training: the loss and its gradients in both packages
# ----------------------------------------------------------------------

def normwise(got, want) -> float:
    """``|got - want| / |want|`` in float64 (``|got|`` where want is 0)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / n if n > 0
                 else np.linalg.norm(got))


def reference_forward(params, cfg, batch):
    """The reference's ``model.forward``; for a float32 audio model, its
    arm run piece by piece on the frames rounded to bf16 and taken in
    float32 (the reference's own forward refuses that model under a
    compiled scan: its carry would change dtype), which is what the port
    computes."""
    import jax.numpy as jnp
    from repro.models import model as M
    from repro.models.layers import rmsnorm
    if cfg.arch_type != "audio" or params["embed"].dtype != jnp.float32:
        return M.forward(params, cfg, batch)
    frames = batch["frames"].astype(jnp.bfloat16).astype(jnp.float32)
    mem = M._encode(params, cfg, frames)
    x = M._embed_tokens(params, cfg, batch["tokens"])
    x, aux = M._trunk(params, cfg, x, jnp.arange(x.shape[1])[None],
                      mem=mem)
    logits = M._logits(params, cfg, rmsnorm(x, params["final_norm"],
                                            cfg.norm_eps))
    onehot = jax.nn.one_hot(batch["labels"], logits.shape[-1],
                            dtype=logits.dtype)
    nll = (jax.nn.logsumexp(logits, axis=-1)
           - jnp.einsum("bsv,bsv->bs", logits, onehot))
    mask = jnp.ones(batch["tokens"].shape, bool)
    loss = (nll * mask).sum() / jnp.maximum(mask.sum(), 1)
    return loss, {"nll": loss, "aux": aux}


def reference_loss_and_grads(params, cfg, batch):
    """``(loss, nll, aux, grads)`` of the reference's training forward,
    run op by op (``jax.disable_jit``), the gradients as
    ``reference_param_arrays``."""
    import jax.numpy as jnp
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.disable_jit():
        (loss, mets), grads = jax.value_and_grad(
            lambda p: reference_forward(p, cfg, batch), has_aux=True)(params)
    return (float(loss), float(mets["nll"]), float(mets["aux"]),
            reference_param_arrays(grads))


def port_loss_and_grads(model, cfg, batch, remat=True):
    """``(loss, nll, aux, grads)`` of the port's ``model.forward`` on
    the CPU, the gradients stacked in the exported layout
    (``interop.params_to_arrays``) as float32 numpy."""
    import torch

    from repro_torch import interop
    from repro_torch.models import model as TM
    named = list(model.named_parameters())
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with TM.trainable(model):
        loss, mets = TM.forward(model, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True,
                                    materialize_grads=True)
    stacked = interop.params_to_arrays(
        {n: g for (n, _), g in zip(named, grads)}, cfg)
    return (float(loss), float(mets["nll"]), float(mets["aux"]),
            {k: v.float().numpy() for k, v in stacked.items()})


class GapSpy:
    """Records, through ``monkeypatch``, the smallest gap among each
    token's top k + 1 router probabilities in the port's MoE layers."""

    def __init__(self, monkeypatch):
        import torch

        from repro_torch.models import moe
        self.gaps = []
        real = moe.route

        def route(p, cfg, x):
            out = real(p, cfg, x)
            probs = torch.softmax(out[0], dim=-1).sort(dim=-1).values
            self.gaps.append(float(probs[..., -(cfg.moe.top_k + 1):].diff(
                dim=-1).min()))
            return out
        monkeypatch.setattr(moe, "route", route)
