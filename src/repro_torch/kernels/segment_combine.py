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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("segment_combine")
        p = ctypes.c_void_p
        i64 = ctypes.c_int64
        lib.segment_sum_launch.argtypes = [p, p, ctypes.c_int32, p, i64,
                                           i64, i64, ctypes.c_int32, p]
        lib.segment_sum_launch.restype = ctypes.c_int
        lib.segment_sum_error_string.argtypes = [ctypes.c_int]
        lib.segment_sum_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def segment_sum_csr_plain(y: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """The kernel's function as an eager loop over the position inside
    a segment (the CPU path, and the kernel's yardstick): row ``r`` adds
    ``y[offsets[r] + k]`` for ``k = 0, 1, ...`` to a float32 ``+0.0``,
    and the sum is rounded once to ``y``'s dtype."""
    n_rows = offsets.shape[0] - 1
    flat = y.reshape(y.shape[0], -1)
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
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        err = lib.segment_sum_launch(
            y.data_ptr(), offsets.data_ptr(),
            int(offsets.dtype == torch.int64), out.data_ptr(), n_rows,
            n_feat, y.shape[0], _DTYPE_CODE[y.dtype], stream)
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
