"""Sliding-window decode attention: the CUDA kernel's wrappers and its
plain version.

One new query token per request attends to the first ``kv_len`` rows of
its KV cache (a ring buffer whose valid rows are a prefix), with
grouped-query attention: query head ``h`` reads KV head ``h // n_rep``.

    o[b, h] = softmax_{t < kv_len[b]}(q[b, h] . k[b, t, g] / sqrt(dh)) . v[b, t, g]

``window_attention`` is the one launch, in the decode path's layout:
``q [B, H, dh]``, ``k``/``v [B, W, Hkv, dh]`` with any strides but a
unit one in ``dh``, so a layer's slice of the stacked cache is read in
place.  ``decode_window_attention`` is the reference's signature
(``q [BH, dh]``, ``k``/``v [BH, W, dh]``, ``kv_len [BH]``), the case
``H = Hkv = 1``, and goes through the same launch.

On a CUDA tensor the wrapper launches ``csrc/window_attention.cu``
(built at first use, see ``_build``) or raises; on a CPU tensor it runs
``kernels.ref.decode_window_attention_ref``, the plain version.  Both
compute in float32 and return float32; they are not bitwise equal (the
kernel's online softmax and its sums run in another order).  The
contract is ``1 <= kv_len <= W``: the decode path never gives 0, and a
check would synchronize the host with the card every layer, so it is
not checked.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_window_attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DH = 256
# each split is a whole number of tiles of the block's 4 warps x 32 rows
_ROWS_QUANTUM = 128
_MIN_SPLIT_ROWS = 128
_BLOCKS_PER_SM = 4
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("window_attention")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.window_attention_launch.argtypes = (
            [p] * 8 + [i32] * 7 + [i64] * 6 + [i32, i32, p])
        lib.window_attention_launch.restype = ctypes.c_int
        lib.window_attention_error_string.argtypes = [ctypes.c_int]
        lib.window_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def split_rows(n_groups: int, w: int, n_sms: int) -> tuple[int, int]:
    """``(chunk, n_splits)``: the rows of W each block of pass 1 takes,
    and how many blocks share a group's W.  Enough splits that the
    ``n_groups * n_splits`` blocks fill ``n_sms`` SMs ``_BLOCKS_PER_SM``
    times over, but no split under ``_MIN_SPLIT_ROWS`` rows; the split
    count depends on W, not on ``kv_len``, which lies on the card."""
    want = max(1, -(-_BLOCKS_PER_SM * n_sms // max(n_groups, 1)))
    n_splits = max(1, min(want, w // _MIN_SPLIT_ROWS))
    chunk = -(-w // n_splits)
    chunk = -(-chunk // _ROWS_QUANTUM) * _ROWS_QUANTUM
    return chunk, -(-w // chunk)


def _check_args(q, k, v, kv_len):
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"window_attention takes q [B, H, dh] and k/v "
                         f"[B, W, Hkv, dh], got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    b, h, dh = q.shape
    if k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError(f"k {tuple(k.shape)} {k.dtype} and v "
                         f"{tuple(v.shape)} {v.dtype} must match")
    if k.shape[0] != b or k.shape[3] != dh or k.shape[1] < 1:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if k.dtype not in _DTYPE_CODE or not q.dtype.is_floating_point:
        raise ValueError(f"window_attention takes a float32 or bfloat16 "
                         f"cache and a float q, got {k.dtype}, {q.dtype}")
    if kv_len.shape != (b,) or kv_len.dtype != torch.int32:
        raise ValueError(f"kv_len must be int32 [{b}], got "
                         f"{tuple(kv_len.shape)} {kv_len.dtype}")
    devices = {t.device for t in (q, k, v, kv_len)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{sorted(map(str, devices))}")


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Decode attention over a KV cache; returns float32 ``[B, H, dh]``.

    q:      [B, H, dh] float (read as float32)
    k, v:   [B, W, Hkv, dh] float32 or bfloat16, unit stride in dh
    kv_len: [B] int32, 1 <= kv_len <= W (the valid prefix of W)

    ``window_attention.launches`` counts the CUDA kernel's launches.
    """
    _check_args(q, k, v, kv_len)
    device = q.device
    if device.type == "cpu":
        return decode_window_attention_ref(q, k, v, kv_len)
    if device.type != "cuda":
        raise ValueError(f"window_attention runs on cuda or cpu, not {device}")
    b, h, dh = q.shape
    w, hkv = k.shape[1], k.shape[2]
    if dh > _MAX_DH:
        raise ValueError(f"the kernel takes dh <= {_MAX_DH}, got {dh}")
    if k.stride(3) != 1 or v.stride(3) != 1 or not kv_len.is_contiguous():
        raise ValueError("k and v need a unit stride in dh, kv_len must be "
                         "contiguous")
    q = q.to(torch.float32).contiguous()
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunk, n_splits = split_rows(b * hkv, w, n_sms)
    # K rows in 16-byte pieces where the layout allows (the stride of a
    # size-1 dimension is never used)
    elt = k.element_size()
    k_vec = (dh * elt % 16 == 0 and k.data_ptr() % 16 == 0
             and all(st * elt % 16 == 0 or n == 1
                     for st, n in zip(k.stride()[:3], k.shape[:3])))
    part_m = torch.empty((b, h, n_splits), dtype=torch.float32, device=device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, n_splits, dh), dtype=torch.float32,
                           device=device)
    out = torch.empty((b, h, dh), dtype=torch.float32, device=device)
    if b == 0 or h == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(device):
        err = lib.window_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            out.data_ptr(), b, h, hkv, w, dh, chunk, n_splits,
            k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
            v.stride(2), _DTYPE_CODE[k.dtype], int(k_vec),
            torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(
            f"window_attention launch failed (q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, {n_splits} splits of {chunk} rows): "
            f"{lib.window_attention_error_string(err).decode()}")
    window_attention.launches += 1
    return out


window_attention.launches = 0


def decode_window_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            kv_len: torch.Tensor) -> torch.Tensor:
    """The reference's signature: q [BH, dh]; k/v [BH, W, dh]; kv_len
    [BH].  Returns float32 [BH, dh], through the one launch."""
    if q.dim() != 2 or k.dim() != 3:
        raise ValueError(f"decode_window_attention takes q [BH, dh] and k/v "
                         f"[BH, W, dh], got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    return window_attention(q[:, None], k[:, :, None], v[:, :, None],
                            kv_len)[:, 0]
