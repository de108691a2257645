"""The shard mesh: the port's counterpart of the reference's 1-D
``Mesh(devices, ("shard",))`` and its three collectives.

The distributed engines write their per-shard code once, as a loop over
``mesh.shards`` (the shards this process drives), and exchange data
only through three operations, each taking one tensor for each of those
shards and returning one for each:

* ``all_to_all(bufs)`` — ``bufs[i]`` is shard ``i``'s ``[M, H, ...]``
  send buffer, row ``j`` addressed to shard ``j``; shard ``j`` gets
  ``[M, H, ...]`` whose row ``i`` came from shard ``i`` (the
  reference's tiled ``all_to_all`` over axis 0: ghost pushes, edge
  pushes, task backflow, the claim combine);
* ``psum(xs)`` — the sum over all shards (termination);
* ``all_gather(xs)`` — the shards' tensors stacked ``[M, ...]`` in
  shard order (the sync merge, MPI-style ALS).

Two implementations give bitwise the same results:

* ``LocalMesh(n_shards, devices)`` — one process drives all M shards,
  as ``shard_map`` does; shard ``i`` lives on ``devices[i % len(devices)]``
  and the collectives are copies between devices (a transpose, a sum in
  shard order, a concatenation).  Eight shards on one GPU are the
  counterpart of the reference's eight virtual devices.
* ``ProcessGroupMesh(group)`` — one shard a rank over
  ``torch.distributed`` (``all_to_all_single`` with equal splits,
  ``all_reduce``, ``all_gather_into_tensor``): several GPUs under NCCL,
  or CPU processes under gloo.  A backend that cannot run an op on the
  shard's device raises; nothing is staged through the host.

Booleans cross as ``uint8`` (gloo has no bool); the bits are unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def _canonical(device) -> torch.device:
    """``cuda`` with its index (the current card's), so a shard's device
    compares equal to its tensors' devices."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def _unwire(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(torch.bool) if dtype == torch.bool else t


class LocalMesh:
    """All ``n_shards`` shards in this process, shard ``i`` on
    ``devices[i % len(devices)]`` (default: the GPU)."""

    def __init__(self, n_shards: int, devices=None):
        if isinstance(n_shards, bool) or not isinstance(n_shards, int) \
                or n_shards < 1:
            raise ValueError(f"n_shards must be a positive int, got "
                             f"{n_shards!r}")
        if devices is None:
            devices = [resolve_device(None)]
        self.devices = [_canonical(d) for d in devices]
        if not self.devices:
            raise ValueError("LocalMesh needs at least one device")
        self.n_shards = n_shards
        self.shards = tuple(range(n_shards))

    def device(self, shard: int) -> torch.device:
        return self.devices[shard % len(self.devices)]

    @property
    def _one_device(self) -> bool:
        return len(set(self.devices)) == 1

    def all_to_all(self, bufs: list) -> list:
        m = self.n_shards
        for b in bufs:
            if b.shape[0] != m:
                raise ValueError(f"all_to_all buffers are [M={m}, ...], "
                                 f"got {tuple(b.shape)}")
        if self._one_device:
            # out[j][i] = bufs[i][j]: one stack, one transposing copy
            return list(torch.stack(bufs, 1).unbind(0))
        return [torch.stack([bufs[i][j].to(self.device(j))
                             for i in range(m)]) for j in range(m)]

    def psum(self, xs: list) -> list:
        total = xs[0]
        for x in xs[1:]:
            total = total + x.to(total.device)
        return [total.to(self.device(i)) for i in range(self.n_shards)]

    def all_gather(self, xs: list) -> list:
        if self._one_device:
            g = torch.stack(xs)
            return [g] * self.n_shards
        return [torch.stack([x.to(self.device(j)) for x in xs])
                for j in range(self.n_shards)]

    def __repr__(self) -> str:
        return (f"LocalMesh({self.n_shards}, "
                f"{[str(d) for d in self.devices]})")


class ProcessGroupMesh:
    """One shard a rank of a ``torch.distributed`` process group (the
    default group unless ``group`` is given), on ``device`` (default:
    ``cuda:<local rank>`` under NCCL, the CPU under gloo)."""

    def __init__(self, group=None, device=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise ValueError("ProcessGroupMesh needs an initialized "
                             "process group (torch.distributed."
                             "init_process_group)")
        self.group = group
        self.n_shards = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.shards = (self.rank,)
        self.backend = str(dist.get_backend(group))
        if device is None:
            device = (torch.device("cuda", self.rank
                                   % max(torch.cuda.device_count(), 1))
                      if self.backend == "nccl" else torch.device("cpu"))
        self._device = _canonical(device)
        if self.backend == "gloo" and self._device.type != "cpu":
            raise ValueError(
                "ProcessGroupMesh: gloo runs these collectives on CPU "
                f"tensors only, and the shard lives on {self._device}; "
                "use the nccl backend for GPU shards")
        if self.backend == "nccl" and self._device.type != "cuda":
            raise ValueError("ProcessGroupMesh: nccl needs CUDA shards, "
                             f"got {self._device}")

    def device(self, shard: int) -> torch.device:
        return self._device

    def _check(self, t: torch.Tensor) -> None:
        if t.device != self._device:
            raise ValueError(f"shard {self.rank}'s tensor is on {t.device}, "
                             f"the mesh's device is {self._device}")

    def all_to_all(self, bufs: list) -> list:
        import torch.distributed as dist
        (buf,) = bufs
        self._check(buf)
        if buf.shape[0] != self.n_shards:
            raise ValueError(f"all_to_all buffers are [M={self.n_shards}, "
                             f"...], got {tuple(buf.shape)}")
        send = _wire(buf).contiguous()
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=self.group)
        return [_unwire(out, buf.dtype)]

    def psum(self, xs: list) -> list:
        import torch.distributed as dist
        (x,) = xs
        self._check(x)
        out = x.clone()
        dist.all_reduce(out, group=self.group)
        return [out]

    def all_gather(self, xs: list) -> list:
        import torch.distributed as dist
        (x,) = xs
        self._check(x)
        # [1, ...] in, [M, ...] out: shards concatenated along dim 0,
        # the layout both gloo and NCCL take
        send = _wire(x).reshape((1,) + tuple(x.shape)).contiguous()
        out = send.new_empty((self.n_shards,) + tuple(x.shape))
        dist.all_gather_into_tensor(out, send, group=self.group)
        return [_unwire(out, x.dtype)]

    def __repr__(self) -> str:
        return (f"ProcessGroupMesh(rank {self.rank} of {self.n_shards}, "
                f"{self.backend}, {self._device})")
