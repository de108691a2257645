"""The mesh context of the model code (``repro.launch.shardctx`` in
PyTorch).

The reference installs a mesh here before tracing, and its model code
then constrains activations with ``hint``.  The port runs on one device
and leaves the hints out of the model code; what stays is the context
and the residual stream's layout, which the dry run reads to split the
activations' bytes over the axes the layout shards
(``residual_spec``).  Axis resolution (drop an axis not on the mesh or
not dividing the dimension) is ``launch.sharding.resolve``.
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
