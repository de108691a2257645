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
hub-split) and ``n_chunks_max``; a split graph also carries the arrays
``owner_of_vrow`` and ``vrow_offset``.

Parameters: the reference's parameter pytree flattened to numpy arrays
keyed by path (``embed``, ``final_norm``, ``out``, ``layers.norm1``,
``layers.mix.wq``, ``layers.ffn.w_gate``, ...; the ``layers.*`` arrays
keep their stacked leading ``[L, ...]`` axis) becomes the port's
``Model`` on a device, bit for bit.  bfloat16 arrives as an
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
        edge_inv_perm=np.asarray(arrays["edge_inv_perm"]))
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
                w_cap=ell.w_cap, n_chunks_max=ell.n_chunks_max)
    return arrays, meta


def _tensor(a) -> torch.Tensor:
    """A CPU tensor of an exported array, bfloat16 (``ml_dtypes``) read
    bitwise through its 16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_arrays(arrays: dict, cfg: ModelConfig, device=None) -> Model:
    """The port's ``Model`` on ``device`` holding the exported reference
    parameters: ``layers.<name>`` ``[L, ...]`` becomes ``layers.<i>.<name>``.
    The dtypes are the arrays' (the weights' from ``embed``); a missing,
    extra or mis-shaped array raises."""
    device = resolve_device(device)
    tensors = {k: _tensor(a) for k, a in arrays.items()}
    model = Model(cfg, dtype=tensors["embed"].dtype, device=device)
    state = {}
    for key, t in tensors.items():
        if key.startswith("layers."):
            if t.shape[0] != cfg.n_layers:
                raise ValueError(f"{key}: {t.shape[0]} layers, the config "
                                 f"has {cfg.n_layers}")
            for i in range(cfg.n_layers):
                state[f"layers.{i}.{key[len('layers.'):]}"] = t[i]
        else:
            state[key] = t
    want = model.state_dict()
    if set(state) != set(want):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(want) - set(state))}, extra "
                         f"{sorted(set(state) - set(want))}")
    for key, t in state.items():
        if t.shape != want[key].shape or t.dtype != want[key].dtype:
            raise ValueError(f"{key}: got {tuple(t.shape)} {t.dtype}, the "
                             f"model has {tuple(want[key].shape)} "
                             f"{want[key].dtype}")
    model.load_state_dict(state)
    return model
