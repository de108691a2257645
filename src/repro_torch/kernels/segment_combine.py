"""Segmented sums: the CUDA kernel's wrapper and its plain versions.

    out[r] = sum_{v : seg_ids[v] == r} y[v]

is stage 2 of hub splitting (virtual-row partials summed onto their
owner rows), the combine of a window's chunk pseudo-rows, and the reduce
of the MapReduce baseline.  The reference computes it with an XLA
scatter-add (``src/repro/kernels/ell_spmv.py:185``, ``segment_combine``).
Every caller of the port lays its segments out contiguously, so the
kernel, ``csrc/segment_combine.cu``, takes the segments as offsets:
``segment_sum_csr(y, offsets)`` sums ``y[offsets[r]:offsets[r+1]]`` in
row order from ``+0.0`` in float32.  The order is fixed, so the result
is bitwise the same on the card and on the CPU (``index_add_`` on CUDA
adds with atomics, in no fixed order, and is not used here).

On a CUDA tensor ``segment_sum_csr`` launches the kernel (built at first
use, see ``_build``) or raises; on a CPU tensor it runs
``segment_sum_csr_plain``, the same float32 adds in the same order.
``segment_combine`` keeps the reference's signature for ids in any
order: ``index_add_`` on the CPU (which adds in index order), and on the
card a stable sort of the ids into segments and the kernel.

The kernel's launch is planned on the host from shapes alone
(``launch_plan``: segments a tile, feature slabs, shared memory, a
persistent grid from the SM count); no offset value is read on the host.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None

SMEM_BLOCK = 232_448     # shared memory a block may use on Hopper (227 KB)
SMEM_SM = 233_472        # shared memory of an SM (228 KB)
SMEM_RESERVED = 1_024    # the system's share of it for each block


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The build's constants (``csrc/segment_combine.cu``'s ``SEG_*``
    macros): consumer threads a block, (segment, feature) pairs a thread,
    the largest stage's bytes of x, stages at most, blocks an SM, the
    bytes of x a tile aims at, and the bytes before the first stage (the
    barriers)."""
    threads: int = 256
    pairs: int = 8
    stage_bytes: int = 65536
    max_stages: int = 16
    blocks_per_sm: int = 2
    tile_bytes: int = 49152
    barrier_bytes: int = 256


DEFAULT_GEOMETRY = Geometry()
MIN_STAGES = 2           # a stage's size leaves room for this many


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    tile_rows: int       # segments a tile
    n_slabs: int         # feature slabs a tile (1 unless F > pairs a tile)
    slab: int            # features a slab
    n_items: int         # tiles x slabs, dealt round-robin to the grid
    stage_x: int         # bytes of x a stage holds, a multiple of 16
    n_stages: int        # stages in a block's ring
    smem_bytes: int      # dynamic shared memory a block
    blocks_per_sm: int
    grid: int


@functools.lru_cache(maxsize=1024)
def launch_plan(n_rows: int, n_src: int, n_feat: int, elt_bytes: int,
                off_bytes: int, n_sm: int,
                geom: Geometry = DEFAULT_GEOMETRY) -> LaunchPlan:
    """The kernel's launch for ``n_rows`` segments of ``x [n_src,
    n_feat]`` (elements of ``elt_bytes``, offsets of ``off_bytes``) on a
    card of ``n_sm`` SMs, from shapes alone.

    A tile holds at most ``threads * pairs`` (segment, feature) pairs,
    and as many segments as average ``tile_bytes`` of x between them, or
    fewer, so that each block of the grid gets two tiles; a wider row is
    cut into slabs of that many features, one segment a tile.  A stage
    holds the tile's offsets (16-byte aligned around them) and
    ``stage_x`` bytes of x: 5/4 of an average tile's x (at least 1 KB),
    at most ``stage_bytes`` and small enough for ``MIN_STAGES`` in a
    block's share of the SM's shared memory; so an average tile is
    summed from one stage, each of its pairs one uninterrupted chain of
    adds.  The ring takes as many stages as the share holds
    (``blocks_per_sm`` blocks, fewer if not even two stages fit), at
    most ``max_stages``; the grid is persistent, that many blocks an
    SM."""
    if min(n_rows, n_feat, n_sm) < 1 or n_src < 0:
        raise ValueError(f"no launch for n_rows={n_rows}, n_src={n_src}, "
                         f"n_feat={n_feat} on {n_sm} SMs")
    pairs = geom.threads * geom.pairs
    x_bytes = n_src * n_feat * elt_bytes
    if n_feat > pairs:
        tile_rows, slab = 1, pairs
    else:
        slab = n_feat
        tile_rows = (pairs // n_feat if x_bytes == 0 else
                     geom.tile_bytes * n_rows // x_bytes)
        spread = -(-n_rows // (2 * geom.blocks_per_sm * n_sm))
        tile_rows = max(1, min(pairs // n_feat, tile_rows, spread))
    n_slabs = -(-n_feat // slab)
    off_area = -(-((tile_rows + 1) * off_bytes + 30) // 16) * 16
    tile_x = tile_rows * x_bytes // n_rows
    for blocks in range(geom.blocks_per_sm, 0, -1):
        share = min(SMEM_BLOCK, SMEM_SM // blocks - SMEM_RESERVED)
        room = (share - geom.barrier_bytes) // MIN_STAGES - off_area
        stage_x = min(max(5 * tile_x // 4, 1024), geom.stage_bytes,
                      room) // 16 * 16
        n_stages = min(geom.max_stages,
                       (share - geom.barrier_bytes) // (off_area + stage_x))
        if (n_stages >= 2 and stage_x >= 16) or blocks == 1:
            break
    if n_stages < 1 or stage_x < 16:
        raise ValueError(f"segment_sum_csr needs more than {SMEM_BLOCK} "
                         f"bytes of shared memory a block for a tile of "
                         f"{tile_rows} segments")
    n_items = -(-n_rows // tile_rows) * n_slabs
    return LaunchPlan(tile_rows=tile_rows, n_slabs=n_slabs, slab=slab,
                      n_items=n_items, stage_x=stage_x, n_stages=n_stages,
                      smem_bytes=(geom.barrier_bytes
                                  + n_stages * (off_area + stage_x)),
                      blocks_per_sm=blocks, grid=min(n_items, blocks * n_sm))


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("segment_combine")
        p = ctypes.c_void_p
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        lib.segment_sum_launch.argtypes = [p, p, i32, p, i64, i64, i64, i32,
                                           i64, i64, i64, i64, i64, p]
        lib.segment_sum_launch.restype = ctypes.c_int
        lib.segment_sum_geometry.argtypes = [p]
        lib.segment_sum_geometry.restype = None
        lib.segment_sum_error_string.argtypes = [ctypes.c_int]
        lib.segment_sum_error_string.restype = ctypes.c_char_p
        got = (ctypes.c_int32 * 7)()
        lib.segment_sum_geometry(got)
        lib.geometry = Geometry(*got)
        _lib = lib
    return _lib


def geometry() -> Geometry:
    """The loaded build's ``Geometry`` (a sweep may build other ones)."""
    return _kernel_lib().geometry


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def segment_sum_csr_plain(y: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """The kernel's function as an eager loop over the position inside
    a segment (the CPU path, and the kernel's yardstick): row ``r`` adds
    ``y[offsets[r] + k]`` for ``k = 0, 1, ...`` to a float32 ``+0.0``,
    and the sum is rounded once to ``y``'s dtype."""
    n_rows = offsets.shape[0] - 1
    flat = y.reshape(y.shape[0], math.prod(y.shape[1:]))
    start = offsets[:-1].long().clamp_min(0)
    length = (offsets[1:].long().clamp_max(y.shape[0]) - start).clamp_min(0)
    acc = torch.zeros((n_rows, flat.shape[1]), dtype=torch.float32,
                      device=y.device)
    most = int(length.max()) if n_rows else 0
    last = max(y.shape[0] - 1, 0)
    for k in range(most):
        live = k < length
        rows = flat.index_select(0, (start + k).clamp_max(last))
        # +0.0 on the rows past their segment: acc is never -0.0, so
        # adding it changes nothing
        acc = acc + torch.where(live[:, None], rows.float(), 0.0)
    return acc.to(y.dtype).reshape((n_rows,) + y.shape[1:])


def segment_sum_csr_serial(y: torch.Tensor,
                           offsets: torch.Tensor) -> torch.Tensor:
    """The plain version's adds, segment by segment on the host: numpy's
    ``cumsum`` adds in order in float32, so the last partial sum of
    ``[+0.0, y[s], ..., y[e - 1]]`` is segment ``[s, e)``'s.  A loop over
    the segments, for a few long ones (the plain version loops over the
    longest segment's positions, each a few launches)."""
    n_rows = offsets.shape[0] - 1
    flat = y.detach().cpu().float().reshape(y.shape[0],
                                            math.prod(y.shape[1:])).numpy()
    off = offsets.cpu().long().numpy()
    out = np.zeros((n_rows, flat.shape[1]), np.float32)
    for r in range(n_rows):
        s, e = max(off[r], 0), min(off[r + 1], y.shape[0])
        if e > s:
            rows = np.concatenate([np.zeros((1, flat.shape[1]), np.float32),
                                   flat[s:e]])
            out[r] = np.cumsum(rows, axis=0, dtype=np.float32)[-1]
    return torch.from_numpy(out).to(y.dtype).reshape((n_rows,) + y.shape[1:])


def segment_sum_csr(y: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum(y[offsets[r]:offsets[r+1]])`` in row order.

    y:       [N, ...] float32 or bfloat16 (summed in float32, the result
             rounded once to y's dtype)
    offsets: [n_rows + 1] int32 or int64, non-decreasing; rows of y at
             or past ``offsets[-1]`` belong to no segment
    returns  [n_rows, ...] in y's dtype

    ``segment_sum_csr.launches`` counts the CUDA kernel's launches.  The
    offsets' values are not read on the host (that would be a sync): an
    offset outside ``[0, N]`` is clamped to it.
    """
    if offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError(f"offsets must be 1-D with n_rows + 1 entries, got "
                         f"{tuple(offsets.shape)}")
    if offsets.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"offsets must be int32 or int64, got "
                         f"{offsets.dtype}")
    if y.dim() < 1:
        raise ValueError("y must have a leading row axis")
    if y.device != offsets.device:
        raise ValueError(f"y is on {y.device}, offsets on {offsets.device}")
    if y.device.type == "cpu":
        return segment_sum_csr_plain(y, offsets)
    if y.device.type != "cuda":
        raise ValueError(f"segment_sum_csr runs on cuda or cpu, not "
                         f"{y.device}")
    if y.dtype not in _DTYPE_CODE:
        raise ValueError(f"y must be float32 or bfloat16, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    n_rows = offsets.shape[0] - 1
    n_feat = 1
    for s in y.shape[1:]:
        n_feat *= s
    out = torch.empty((n_rows,) + tuple(y.shape[1:]), dtype=y.dtype,
                      device=y.device)
    if out.numel() == 0:
        return out
    offsets = offsets.contiguous()
    lib = _kernel_lib()
    plan = launch_plan(n_rows, y.shape[0], n_feat, y.element_size(),
                       offsets.element_size(), _sm_count(y.device.index),
                       lib.geometry)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        err = lib.segment_sum_launch(
            y.data_ptr(), offsets.data_ptr(),
            int(offsets.dtype == torch.int64), out.data_ptr(), n_rows,
            n_feat, y.shape[0], _DTYPE_CODE[y.dtype], plan.tile_rows,
            plan.n_slabs, plan.stage_x, plan.n_stages, plan.grid, stream)
    if err:
        raise RuntimeError(f"segment_sum launch failed: "
                           f"{lib.segment_sum_error_string(err).decode()}")
    segment_sum_csr.launches += 1
    return out


segment_sum_csr.launches = 0


def segment_offsets(seg_ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The ``[n_rows + 1]`` offsets of non-decreasing segment ids (ids
    at or past ``n_rows`` sort last and fall outside every segment)."""
    bounds = torch.arange(n_rows + 1, dtype=seg_ids.dtype,
                          device=seg_ids.device)
    return torch.searchsorted(seg_ids.contiguous(), bounds)


def segment_combine(y: torch.Tensor, seg_ids: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """The reference's signature: ``out[r] = sum_{seg_ids[v] == r} y[v]``
    over ``[n_rows, ...]``, ids ``>= n_rows`` (the sentinel) dropped, ids
    in any order.  On the CPU an ``index_add_`` into float zeros (index
    order); on the card the rows are stably sorted by id, which keeps
    index order inside a segment, and summed by ``segment_sum_csr``."""
    if y.device.type == "cpu":
        keep = (seg_ids >= 0) & (seg_ids < n_rows)
        out = torch.zeros((n_rows,) + tuple(y.shape[1:]), dtype=y.dtype)
        return out.index_add_(0, seg_ids[keep].long(), y[keep])
    ids = torch.where(seg_ids >= 0, seg_ids.long(), n_rows)
    ids, order = torch.sort(ids, stable=True)
    return segment_sum_csr(y.index_select(0, order).contiguous(),
                           segment_offsets(ids, n_rows))
