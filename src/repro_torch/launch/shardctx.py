"""The mesh context of the model code (``repro.launch.shardctx`` in
PyTorch).

The reference installs a mesh here before tracing, and its model code
then constrains activations with ``hint``.  Here ``hint`` and
``residual_hint`` act on DTensors (the partitioned dry run's, see
``launch.dryrun``): a DTensor is redistributed to the placements of the
resolved spec on its own mesh, each collective that costs counted by
the op walker.  A plain tensor -- every run on one device -- is
returned as it is, with no op.  Axis resolution (drop an axis not on
the mesh or not dividing the dimension) is ``launch.sharding.resolve``.
"""
from __future__ import annotations

import contextlib
from typing import Any

_MESH: Any = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


DP = ("pod", "data")    # batch/FSDP axis bundle
TP = "model"

# residual-stream layout between layers: "d" shards d_model over TP
# (baseline), "seq" shards the sequence axis instead (Megatron-SP style)
RESIDUAL_LAYOUT = "d"


def set_residual_layout(kind: str) -> None:
    global RESIDUAL_LAYOUT
    if kind not in ("d", "seq"):
        raise ValueError(f"the residual layout is 'd' or 'seq', got {kind!r}")
    RESIDUAL_LAYOUT = kind


def residual_spec() -> tuple:
    """The spec ``residual_hint`` gives the residual stream [B, S, d]."""
    if RESIDUAL_LAYOUT == "seq":
        return (DP, TP, None)
    return (DP, None, TP)


def is_distributed(x) -> bool:
    """``x`` is a DTensor."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def hint(x, *spec):
    """``x`` laid out as ``spec`` (one entry a dimension: None, an axis
    or a bundle of axes), resolved on the DTensor's mesh; a plain tensor
    is returned unchanged."""
    if not is_distributed(x):
        return x
    from repro_torch.launch import sharding
    want = sharding.placements(spec, x.device_mesh, tuple(x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def residual_hint(x):
    """The configured residual-stream layout on [B, S, d]."""
    return hint(x, *residual_spec())


def heads_spec(shape, n_heads: int, mesh) -> tuple:
    """The placements of ``[B, .., H * dh]`` before its split into
    ``n_heads`` heads: the batch over the data axes, the heads over
    ``"model"`` where it divides ``n_heads`` (resolved on the head count,
    not on ``H * dh``: a block of a head cannot be split off), else
    whole."""
    from repro_torch.launch import sharding
    spec = (DP,) + (None,) * (len(shape) - 2) + (TP,)
    return sharding.placements(spec, mesh, tuple(shape[:-1]) + (n_heads,))


def heads_hint(x, n_heads: int):
    """``x [B, .., H * dh]`` laid out for its split into heads
    (``heads_spec``); a plain tensor is returned unchanged."""
    if not is_distributed(x):
        return x
    want = heads_spec(x.shape, n_heads, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
