"""Device-free mesh descriptions for the dry run and the sharding rules
(``repro.launch.mesh`` in PyTorch).

A ``DeviceMesh`` is only axis names and sizes: what the sharding rules
read.  ``torch_mesh`` turns one into a ``torch.distributed``
``DeviceMesh`` over a fake process group (no devices, no data moved),
on which the dry run's DTensors live and DTensor partitions the step,
as XLA's SPMD partitioner does for the reference.  The production meshes
are the reference's: one pod, 16 x 16 = 256 chips, axes ``("data",
"model")``; two pods, 2 x 16 x 16 = 512 chips, axes ``("pod", "data",
"model")``, where ``"pod"`` is pure data parallelism.  ``"1"`` is one
card: no axes, every spec replicated.

The reference's ``make_host_mesh`` (a 1-D mesh over local devices for
the graph engine) is ``repro_torch.core.mesh.LocalMesh``.
"""
from __future__ import annotations

import contextlib
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


def of_torch_mesh(tm) -> DeviceMesh:
    """The axis names and sizes of a ``torch.distributed`` mesh."""
    return DeviceMesh(tuple(tm.mesh_dim_names), tuple(tm.shape))


@contextlib.contextmanager
def torch_mesh(mesh: DeviceMesh, device_type: str = "cpu"):
    """A ``torch.distributed.device_mesh.DeviceMesh`` of ``mesh``'s shape
    and axis names over a fake default group of ``mesh.size`` ranks
    (this process is rank 0; a collective completes at once and moves
    nothing).  The group is destroyed on exit, whatever happens.  Raises
    if a default group exists (a group left behind would leak into the
    next user of the process), or for the one-card mesh, which has no
    axes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not mesh.axis_names:
        raise ValueError("the one-card mesh has no torch mesh")
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield init_device_mesh(device_type, mesh.shape,
                               mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()
