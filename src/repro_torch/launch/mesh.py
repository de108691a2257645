"""Device-free mesh descriptions for the dry run and the sharding rules
(``repro.launch.mesh`` in PyTorch).

A ``DeviceMesh`` is only axis names and sizes: the port has no SPMD
partitioner, so a mesh here is what the sharding rules read and what
the dry run divides its bytes by, never devices.  The production meshes
are the reference's: one pod, 16 x 16 = 256 chips, axes ``("data",
"model")``; two pods, 2 x 16 x 16 = 512 chips, axes ``("pod", "data",
"model")``, where ``"pod"`` is pure data parallelism.  ``"1"`` is one
card: no axes, every spec replicated.

The reference's ``make_host_mesh`` (a 1-D mesh over local devices for
the graph engine) is ``repro_torch.core.mesh.LocalMesh``.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    @property
    def size(self) -> int:
        """Chips in the mesh."""
        return math.prod(self.shape)

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def name(self) -> str:
        """``"16x16"``, ``"2x16x16"``, or ``"1"`` for one card."""
        return "x".join(map(str, self.shape)) or "1"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    if multi_pod:
        return DeviceMesh(("pod", "data", "model"), (2, 16, 16))
    return DeviceMesh(("data", "model"), (16, 16))


def one_card_mesh() -> DeviceMesh:
    return DeviceMesh((), ())


def parse_mesh(name: str) -> DeviceMesh:
    """``"1"``, ``"16x16"`` or ``"2x16x16"`` (the axes are the
    production meshes')."""
    if name == "1":
        return one_card_mesh()
    shape = tuple(int(p) for p in name.split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if axes is None:
        raise ValueError(f"a mesh is '1', 'DxM' or 'PxDxM', got {name!r}")
    return DeviceMesh(axes, shape)


def data_axes(mesh) -> tuple:
    """The batch/FSDP axis bundle: ("pod","data") multi-pod, else ("data",)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
