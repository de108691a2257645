"""Carry a graph or a model's parameters across between ``repro`` and
the port as numpy arrays.

A reference ``DataGraph`` exported to a dict of numpy arrays plus a
small ``meta`` dict becomes a port ``DataGraph`` on identical storage:
the same bucket blocks, permutation, degrees, colors, edge renumbering
and vertex/edge data.  Both engines then run on the same graph, so a
comparison of their results compares the engines and nothing else.
The export of a reference graph lives in the tests, because this
package never imports JAX; ``graph_to_arrays`` is the same export for a
port graph.

Array keys: ``nbrs.<b>``, ``nbr_mask.<b>``, ``edge_ids.<b>``,
``is_src.<b>`` per bucket ``b``; ``perm``, ``inv_perm``, ``degree``,
``edges``, ``edge_perm``, ``edge_inv_perm``, optionally ``colors``; and
``vertex.<name>`` / ``edge.<name>`` for the data (edge data includes
the pad row; a uint32 array arrives as int64 of the same values).  Meta keys: ``n_vertices``, ``n_edges``, ``max_deg``,
``widths``, ``starts``, ``pad_edge``, ``w_cap`` (None unless the graph is
hub-split), ``n_chunks_max`` and optionally ``slack`` (0 when absent:
frozen storage); a split graph also carries the arrays
``owner_of_vrow`` and ``vrow_offset``.

Parameters: the reference's parameter pytree flattened to numpy arrays
keyed by path (``embed``, ``final_norm``, ``out``, ``layers.norm1``,
``layers.mix.wq``, ``layers.ffn.router``, ``layers.mix.in_proj``,
``layers.cross.wq``, ``layers.norm_x``, ``enc_layers.*``, ``enc_norm``,
``projector.w1``, and the hybrid's ``layers.l<j>.*``; a stack keeps its
leading axis: ``[L, ...]``, ``[n_enc_layers, ...]``, or ``[n_periods,
...]`` for the hybrid) becomes the port's ``Model`` on a device, bit
for bit.  A serving state flattened the same way (``cache_k``,
``cache_v``, ``cache_len``, ``mamba_state.h``, ``mamba_state.conv``,
``mem_k``, ``mem_v``; a part the reference keeps as ``{}`` absent)
becomes the port's ``ServeState``, and the reference's AdamW state
(``m.<key>``, ``v.<key>``, ``step``) the port's (``opt_state_from_arrays``).
``params_to_arrays`` exports the port's parameters in that layout
again.  bfloat16 arrives as an
``ml_dtypes`` array, which this package reads through its raw 16 bits,
so it never imports ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import DataGraph, SlicedEll, flat_slots
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serve.engine import (ServeState, _n_attn_layers,
                                      _n_mamba_layers)

_BLOCKS = ("nbrs", "nbr_mask", "edge_ids", "is_src")


def _widen_u32(a: np.ndarray) -> np.ndarray:
    """uint32 arrays (the reference's Gibbs keys) as int64 holding the
    same values: the port keeps 32-bit words in int64 (``apps.gibbs``)."""
    return a.astype(np.int64) if a.dtype == np.uint32 else a


def graph_from_arrays(arrays: dict, meta: dict, device=None) -> DataGraph:
    """A port ``DataGraph`` on ``device`` from exported arrays."""
    device = resolve_device(device)
    up = lambda a: torch.from_numpy(_widen_u32(np.array(a))).to(device)
    widths = tuple(int(w) for w in meta["widths"])
    starts = tuple(int(s) for s in meta["starts"])
    blocks = [[arrays[f"{f}.{b}"] for b in range(len(widths))]
              for f in _BLOCKS]
    ell = SlicedEll(
        widths=widths, starts=starts, n_rows=int(meta["n_vertices"]),
        max_deg=int(meta["max_deg"]), pad_edge=int(meta["pad_edge"]),
        slots=flat_slots(blocks, starts, widths, int(meta["pad_edge"]),
                         device),
        perm=up(arrays["perm"]), inv_perm=up(arrays["inv_perm"]),
        w_cap=None if meta.get("w_cap") is None else int(meta["w_cap"]),
        n_chunks_max=int(meta.get("n_chunks_max", 1)),
        owner_of_vrow=(up(arrays["owner_of_vrow"])
                       if "owner_of_vrow" in arrays else None),
        vrow_offset=(up(arrays["vrow_offset"])
                     if "vrow_offset" in arrays else None))
    graph = DataGraph(
        n_vertices=int(meta["n_vertices"]), n_edges=int(meta["n_edges"]),
        max_deg=int(meta["max_deg"]), ell=ell, degree=up(arrays["degree"]),
        vertex_data={k[len("vertex."):]: up(v) for k, v in arrays.items()
                     if k.startswith("vertex.")},
        edge_data={k[len("edge."):]: up(v) for k, v in arrays.items()
                   if k.startswith("edge.")},
        edges_np=np.asarray(arrays["edges"], dtype=np.int64),
        edge_perm=np.asarray(arrays["edge_perm"]),
        edge_inv_perm=np.asarray(arrays["edge_inv_perm"]),
        slack=int(meta.get("slack", 0)))
    if "colors" in arrays:
        graph = graph.with_colors(arrays["colors"])
    return graph


def graph_to_arrays(graph: DataGraph) -> tuple[dict, dict]:
    """The ``(arrays, meta)`` export of a port graph."""
    host = lambda t: t.cpu().numpy()
    ell = graph.ell
    arrays = {f"{f}.{b}": host(getattr(ell, f)[b])
              for f in _BLOCKS for b in range(ell.n_buckets)}
    arrays.update(perm=host(ell.perm), inv_perm=host(ell.inv_perm),
                  degree=host(graph.degree), edges=graph.edges_np,
                  edge_perm=graph.edge_perm,
                  edge_inv_perm=graph.edge_inv_perm)
    if graph.colors is not None:
        arrays["colors"] = host(graph.colors)
    if ell.is_split:
        arrays.update(owner_of_vrow=host(ell.owner_of_vrow),
                      vrow_offset=host(ell.vrow_offset))
    arrays.update({f"vertex.{k}": host(v)
                   for k, v in graph.vertex_data.items()})
    arrays.update({f"edge.{k}": host(v) for k, v in graph.edge_data.items()})
    meta = dict(n_vertices=graph.n_vertices, n_edges=graph.n_edges,
                max_deg=graph.max_deg, widths=list(ell.widths),
                starts=list(ell.starts), pad_edge=ell.pad_edge,
                w_cap=ell.w_cap, n_chunks_max=ell.n_chunks_max,
                slack=graph.slack)
    return arrays, meta


def _tensor(a) -> torch.Tensor:
    """A CPU tensor of an exported array, bfloat16 (``ml_dtypes``) read
    bitwise through its 16 bits; a tensor is taken as it is."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _stacks(cfg: ModelConfig) -> dict[str, int]:
    """Key prefix of each stacked set of layers -> its stacked length."""
    if cfg.arch_type == "hybrid":
        return {f"layers.l{j}": cfg.n_layers // cfg.attn_every
                for j in range(cfg.attn_every)}
    out = {"layers": cfg.n_layers}
    if cfg.arch_type == "audio":
        out["enc_layers"] = cfg.n_enc_layers
    return out


def _stacked_name(name: str):
    """A port parameter name -> ``(exported key, stack, layer index)``:
    the first all-digit part of the name is the layer's index in its
    stack (``layers.3.mix.wq`` -> ``("layers.mix.wq", "layers", 3)``,
    the hybrid's ``layers.l1.0.norm1`` -> ``("layers.l1.norm1",
    "layers.l1", 0)``); a name with none is not stacked (``(name, None,
    None)``)."""
    parts = name.split(".")
    for i, part in enumerate(parts):
        if part.isdigit():
            return (".".join(parts[:i] + parts[i + 1:]),
                    ".".join(parts[:i]), int(part))
    return name, None, None


def _unstack(tensors: dict, like: dict, what: str) -> dict:
    """Exported tensors (stacks ``[n, ...]``) cut into the port's names
    of ``like``: the set of names, the layer counts, the shapes and the
    dtypes must be ``like``'s."""
    state, want_stack = {}, {}
    for name in like:
        key, _, i = _stacked_name(name)
        if key not in tensors:
            raise ValueError(f"{what} names differ: missing {key!r}")
        t = tensors[key]
        if i is not None:
            want_stack[key] = max(want_stack.get(key, 0), i + 1)
            t = t[i] if i < t.shape[0] else None
        state[name] = t
    for key, n in want_stack.items():
        if tensors[key].shape[0] != n:
            raise ValueError(f"{key}: {tensors[key].shape[0]} stacked "
                             f"layers, the config has {n}")
    extra = set(tensors) - {_stacked_name(n)[0] for n in like}
    if extra:
        raise ValueError(f"{what} names differ: extra {sorted(extra)}")
    for name, t in state.items():
        w = like[name]
        if t.shape != w.shape or t.dtype != w.dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, the "
                             f"model has {tuple(w.shape)} {w.dtype}")
    return state


def params_from_arrays(arrays: dict, cfg: ModelConfig, device=None) -> Model:
    """The port's ``Model`` on ``device`` holding the exported reference
    parameters: a stacked ``<stack>.<name>`` ``[n, ...]`` becomes
    ``<stack>.<i>.<name>`` (stacks: ``layers``, ``enc_layers``, the
    hybrid's ``layers.l<j>``).  The arrays may be numpy (bfloat16 as
    ``ml_dtypes``) or tensors.  The dtypes are the arrays' (the weights'
    from ``embed``); a missing, extra or mis-shaped array raises."""
    device = resolve_device(device)
    tensors = {k: _tensor(a) for k, a in arrays.items()}
    model = Model(cfg, dtype=tensors["embed"].dtype, device=device)
    model.load_state_dict(_unstack(tensors, model.state_dict(),
                                   "parameter"))
    return model


def params_to_arrays(params, cfg: ModelConfig) -> dict:
    """The inverse of ``params_from_arrays``: a ``Model``'s parameters
    (or a dict of its parameter names to tensors, such as gradients or
    moments) with each stack's layers stacked back to ``[n, ...]`` under
    the exported key (``layers.mix.wq``, ``layers.l<j>.*``,
    ``enc_layers.*``).  Tensors on the parameters' device, detached: a
    bfloat16 array has no numpy dtype without ``ml_dtypes``."""
    items = (params.state_dict() if isinstance(params, torch.nn.Module)
             else params)
    stacks = _stacks(cfg)
    out, rows = {}, {}
    for name, t in items.items():
        key, stack, i = _stacked_name(name)
        if i is None:
            out[key] = t.detach()
        else:
            rows.setdefault((key, stack), {})[i] = t.detach()
    for (key, stack), layer in rows.items():
        n = stacks[stack]
        if sorted(layer) != list(range(n)):
            raise ValueError(f"{key}: layers {sorted(layer)}, the config "
                             f"has {n}")
        out[key] = torch.stack([layer[i] for i in range(n)])
    return out


def opt_state_from_arrays(arrays: dict, like_params: Model):
    """An exported reference ``AdamWState`` (``m.<key>`` and ``v.<key>``
    in the parameters' exported layout, float32, and the int32 scalar
    ``step``) as the port's ``optim.adamw.AdamWState`` for
    ``like_params``, on its device: the moments under the port's
    parameter names."""
    from repro_torch.optim.adamw import AdamWState
    like = dict(like_params.named_parameters())
    device = next(iter(like.values())).device
    f32 = {n: p.new_empty(p.shape, dtype=torch.float32)
           for n, p in like.items()}
    parts = {}
    for part in ("m", "v"):
        tensors = {k[len(part) + 1:]: _tensor(a) for k, a in arrays.items()
                   if k.startswith(part + ".")}
        parts[part] = {n: t.to(device) for n, t in
                       _unstack(tensors, f32, f"{part} moment").items()}
    step = _tensor(arrays["step"])
    if step.shape != () or step.dtype != torch.int32:
        raise ValueError(f"step: got {tuple(step.shape)} {step.dtype}, "
                         "want an int32 scalar")
    return AdamWState(parts["m"], parts["v"], step.to(device))


def serve_state_from_arrays(arrays: dict, cfg: ModelConfig,
                            device=None) -> ServeState:
    """The port's ``ServeState`` on ``device`` holding an exported
    reference state bit for bit.  The parts ``cfg``'s family has must be
    there and no other; their layer counts must be the config's."""
    device = resolve_device(device)
    la, lm = _n_attn_layers(cfg), _n_mamba_layers(cfg)
    want = {"cache_len": None}
    if la:
        want.update(cache_k=la, cache_v=la)
    if lm:
        want.update({"mamba_state.h": lm, "mamba_state.conv": lm})
    if cfg.enc_dec:
        want.update(mem_k=cfg.n_layers, mem_v=cfg.n_layers)
    if set(arrays) != set(want):
        raise ValueError(f"state parts differ: missing "
                         f"{sorted(set(want) - set(arrays))}, extra "
                         f"{sorted(set(arrays) - set(want))}")
    up = {}
    for key, n in want.items():
        t = _tensor(arrays[key])
        if n is not None and t.shape[0] != n:
            raise ValueError(f"{key}: {t.shape[0]} layers, the config has "
                             f"{n}")
        up[key] = t.to(device)
    ms = ({"h": up["mamba_state.h"], "conv": up["mamba_state.conv"]}
          if lm else None)
    return ServeState(up.get("cache_k"), up.get("cache_v"), up["cache_len"],
                      ms, up.get("mem_k"), up.get("mem_v"))
