"""Sharding rules: parameter, batch and serving-state specs (FSDP x TP)
for a ``launch.mesh.DeviceMesh`` (``repro.launch.sharding`` in PyTorch).

A spec is a tuple with one entry a dimension: ``None`` (replicated), an
axis name, or a tuple of axis names (sharded over their product).  The
rules are the reference's:

* weights: FSDP over the data axis bundle on the d_model-ish dimension,
  tensor parallel over ``"model"`` on heads / ffn hidden / experts; an
  axis that does not divide its dimension is dropped;
* batches: the batch dimension over the data bundle (or ``"data"``
  alone, or nothing, as the global batch divides);
* KV caches: batch over data, cache rows over ``"model"`` when the ring
  has at least 4,096 rows, and over every axis at batch 1 (long_500k).

The reference sees its layers stacked on a leading axis and pads its
specs with ``None`` for it; the port's layers are one module each, so
the rules here are written against the logical rank and the port's
names (``layers.3.ffn.w_gate``, the hybrid's ``layers.l1.0.mix.in_proj``):
a rule reads the name with its layer indices dropped.  The serving
state is stacked in both packages (``[L, B, W, Hkv, dh]``).

``placements`` maps a spec onto DTensor placements and
``distribute_tree`` makes a tree's tensors DTensors on a torch mesh
(``launch.mesh.torch_mesh``) under its specs: the partitioned dry run's
arguments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import InputShape, ModelConfig

Spec = tuple


def _rule(path: str, F, T):
    """The spec of a parameter's trailing logical dimensions, or None
    (replicate)."""
    if "norm" in path or path.endswith(("conv_b", "dt_bias", "D")):
        return ()
    if "embed" in path or path.endswith("out"):
        return (T, F)
    if path.endswith(("wq", "wk", "wv")):
        return (F, T)
    if path.endswith("wo"):
        return (T, F)
    if path.endswith("router"):
        return (F, None)
    if path.endswith(("w_gate", "w_up")):
        return (F, T)
    if path.endswith("w_down"):
        return (T, F)
    if path.endswith("in_proj"):
        return (F, T)
    if path.endswith("out_proj"):
        return (T, F)
    if path.endswith("x_proj"):
        return (T, None)
    if path.endswith("dt_proj"):
        return (None, T)
    if path.endswith("conv_w"):
        return (None, T)
    if path.endswith("A_log"):
        return (T, None)
    if path.endswith(("w1", "w2")):       # vlm projector
        return (F, T) if path.endswith("w1") else (T, F)
    return None   # replicate


_MOE_KEYS = ("w_gate", "w_up", "w_down")


def _axes_size(mesh, ax) -> int:
    sizes = mesh.sizes
    return sizes[ax] if isinstance(ax, str) else math.prod(sizes[a]
                                                           for a in ax)


def logical_name(name: str) -> str:
    """A parameter's name with its layer indices dropped
    (``layers.3.mix.wq`` -> ``layers.mix.wq``): the reference's key of
    the stack it belongs to."""
    return ".".join(p for p in name.split(".") if not p.isdigit())


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(params, cfg: ModelConfig, mesh, fsdp: bool = True) -> dict:
    """name -> spec for every parameter of ``params`` (a ``Model`` or a
    dict of name -> tensor); ``()`` replicates.  ``fsdp=False`` is the
    serving layout: weights resident, sharded over the model axis
    only."""
    F = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    F = (F if len(F) > 1 else (F[0] if F else None)) if fsdp else None
    T = "model" if "model" in mesh.axis_names else None

    def spec_for(name, leaf):
        path = logical_name(name)
        base = _rule(path, F, T)
        if base is None:
            return ()
        # expert weights [E, d, dff] / [E, dff, d]: experts over the model
        # axis, the d_model-ish dimension over FSDP
        if path.endswith(_MOE_KEYS) and leaf.dim() >= 3:
            base = (T, F, None)
        lead = leaf.dim() - len(base)
        fixed = tuple(ax if ax is None or dim % _axes_size(mesh, ax) == 0
                      else None
                      for dim, ax in zip(leaf.shape[lead:], base))
        return (None,) * lead + fixed

    return {n: spec_for(n, p) for n, p in _named(params).items()}


def _data_spec(mesh, batch: int):
    """The batch dimension's entry: the data bundle where it divides the
    batch, else ``"data"`` where that does, else None."""
    sizes = mesh.sizes
    D = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    if batch % math.prod(sizes[a] for a in D) != 0:
        D = ("data",) if batch % sizes.get("data", 1) == 0 else ()
    return (D if len(D) != 1 else D[0]) if D else None


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh,
                batch_struct: dict) -> dict:
    d = _data_spec(mesh, shape.global_batch)
    return {k: (d,) + (None,) * (v.dim() - 1)
            for k, v in batch_struct.items()}


def serve_state_specs(cfg: ModelConfig, shape: InputShape, mesh, state):
    """Specs in the structure of ``state`` (a ``serve.engine.ServeState``;
    a part that is None stays None)."""
    sizes = mesh.sizes
    Dspec = _data_spec(mesh, shape.global_batch)
    T = "model" if "model" in mesh.axis_names else None
    tsz = sizes.get("model", 1)

    def kv_spec(leaf):
        # [L, B, W, Hkv, dh]
        bb, w = leaf.shape[1:3]
        spec = [None, Dspec, None, None, None]
        if w % tsz == 0 and w >= 4096:
            spec[2] = T
        if bb == 1:
            # long_500k: shard cache rows over everything that divides
            spec[1] = None
            full = tuple(mesh.axis_names)
            if w % math.prod(sizes[a] for a in full) == 0:
                spec[2] = full
        return tuple(spec)

    def generic(leaf):
        if leaf.dim() == 0:
            return ()
        spec = [None] * leaf.dim()
        if leaf.dim() == 1:       # cache_len [B]
            spec[0] = Dspec if leaf.shape[0] > 1 else None
            return tuple(spec)
        if leaf.shape[1] == shape.global_batch and shape.global_batch > 1:
            spec[1] = Dspec
        # mamba h: [L, B, di, ds] -- di over model
        if leaf.dim() >= 3 and leaf.shape[-2] % tsz == 0 \
                and leaf.shape[-2] >= 1024:
            spec[-2] = T
        elif leaf.dim() >= 3 and leaf.shape[-1] % tsz == 0 \
                and leaf.shape[-1] >= 1024:
            spec[-1] = T
        return tuple(spec)

    def opt(fn, t):
        return None if t is None else fn(t)

    return dataclasses.replace(
        state,
        cache_k=opt(kv_spec, state.cache_k),
        cache_v=opt(kv_spec, state.cache_v),
        cache_len=generic(state.cache_len),
        mamba_state=(None if state.mamba_state is None else
                     {k: generic(t) for k, t in state.mamba_state.items()}),
        mem_k=opt(kv_spec, state.mem_k),
        mem_v=opt(kv_spec, state.mem_v))


# ----------------------------------------------------------------------
# Resolution and per-device sizes
# ----------------------------------------------------------------------

def resolve(shape, spec, mesh) -> Spec:
    """The reference's ``shardctx.hint`` rule: an axis not on the mesh,
    or whose axes do not divide the dimension, is dropped; a bundle
    keeps the axes the mesh has."""
    names = set(mesh.axis_names)
    fixed = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            fixed.append(None)
            continue
        axs = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,))
                    if a in names)
        if axs and dim % _axes_size(mesh, axs) == 0:
            fixed.append(axs if len(axs) > 1 else axs[0])
        else:
            fixed.append(None)
    return tuple(fixed) + (None,) * (len(shape) - len(fixed))


def shard_factor(spec, mesh) -> int:
    """How many ways ``spec`` splits a tensor (the product of the sizes
    of the axes it names)."""
    return math.prod(_axes_size(mesh, ax) for ax in spec if ax is not None)


def shard_shape(shape, spec, mesh) -> tuple:
    """One device's block of a tensor of ``shape`` under ``spec`` (a
    spec shorter than the shape leaves the rest replicated)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-d // (1 if ax is None else _axes_size(mesh, ax)))
                 for d, ax in zip(shape, spec))


def shard_bytes(t: torch.Tensor, spec, mesh) -> int:
    """One device's bytes of ``t`` under ``spec``."""
    return math.prod(shard_shape(t.shape, spec, mesh)) * t.element_size()


def flatten(tree, prefix: str = "") -> dict:
    """The leaves of a tree of dicts and dataclasses (a ``ServeState``,
    an ``AdamWState``, a batch) keyed by their dotted paths; None parts
    are left out.  A tensor or a spec tuple is a leaf."""
    if tree is None:
        return {}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def tree_bytes(tree, specs: Any, mesh) -> int:
    """One device's bytes of every tensor of ``tree`` under ``specs``
    (the same structure; the specs of a ``Model`` are a dict by
    parameter name)."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    leaves, spec_leaves = flatten(tree), flatten(specs)
    return sum(shard_bytes(t, spec_leaves[k], mesh)
               for k, t in leaves.items())


# ----------------------------------------------------------------------
# DTensor placements
# ----------------------------------------------------------------------

def placements(spec, mesh, shape=None) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (the port's
    ``DeviceMesh`` or a torch one), one a mesh axis: an axis that shards
    dimension ``i`` is ``Shard(i)``, any other ``Replicate()``; a
    dimension over a bundle (``("pod", "data")``) is ``Shard(i)`` on each
    of its axes.  With ``shape`` the spec is resolved first
    (``resolve``: what the reference's ``hint`` does)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _port_mesh(mesh)
    if shape is not None:
        spec = resolve(shape, spec, mesh)
    out = [Replicate()] * len(mesh.axis_names)
    for i, ax in enumerate(spec):
        for a in () if ax is None else (ax if isinstance(ax, tuple)
                                         else (ax,)):
            out[mesh.axis_names.index(a)] = Shard(i)
    return tuple(out)


def _port_mesh(mesh):
    if hasattr(mesh, "mesh_dim_names"):
        from repro_torch.launch.mesh import of_torch_mesh
        return of_torch_mesh(mesh)
    return mesh


def distribute(t: torch.Tensor, spec, tm):
    """``t`` as a DTensor on the torch mesh ``tm`` under ``spec``: this
    rank's block of it (``shard_shape``), cut locally, with no
    collective."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, tm, placements(spec, tm),
                             src_data_rank=None)


def distribute_tree(tree, specs, tm):
    """``tree`` (a ``Model``, whose parameters are replaced in place and
    which is returned; a dict; a dataclass such as a ``ServeState`` or
    an ``AdamWState``; a tensor) with every tensor a DTensor on ``tm``
    under its spec from ``specs`` (the same structure; a ``Model``'s are
    by parameter name).  None parts stay None."""
    if isinstance(tree, torch.nn.Module):
        for name, p in list(tree.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(mod_name) if mod_name else tree
            setattr(mod, leaf, torch.nn.Parameter(
                distribute(p.detach(), specs[name], tm),
                requires_grad=p.requires_grad))
        return tree
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return distribute(tree, specs, tm)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: distribute_tree(getattr(tree, f.name),
                                    getattr(specs, f.name), tm)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], tm) for k, v in tree.items()}
    raise TypeError(f"distribute_tree: {type(tree).__name__}")
