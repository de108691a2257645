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
``window_attention_partial`` is the same launch's partial entry: the
merged row of its splits left unnormalised, ``(o, m, l)`` with ``o / l``
the attention, which the ranks of a row-sharded cache merge
(``kernels.window_attention_spmd``); it takes ``0 <= kv_len <= W``.

On a CUDA tensor the wrapper launches ``csrc/window_attention.cu``
(built at first use, see ``_build``) or raises; on a CPU tensor it runs
``kernels.ref.decode_window_attention_ref``, the plain version; on a
meta tensor (the dry run) it returns an empty float32 ``[B, H, dh]``
and computes nothing.  Inside ``roofline.op_walk.OpWalk`` a call is
counted as the kernel's own work (``attention_work`` at the full
window: the dry run's caches are full), whichever of the three ran.
The CUDA kernel and the plain version
compute in float32 and return float32; they are not bitwise equal (the
kernel's online softmax and its sums run in another order, and a bf16
cache goes through the tensor cores with q and p as two bf16 terms
each, ~2e-6 from float32).  The contract is ``1 <= kv_len <= W``: the
decode path never gives 0, and a check would synchronize the host with
the card every layer, so it is not checked.

The launch splits W over blocks (``split_rows``, cached) and merges the
splits inside the same launch: the last block of a (request, KV head)
to finish draws the last ticket of an int32 buffer kept per device and
stream, which every launch leaves zero again.  The wrapper allocates
the float32 partials with one ``torch.empty`` and caches the SM count
and the bf16 body's resident blocks an SM per device, so a launch adds
no host call beyond the allocations and the ctypes call.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (decode_window_attention_partial_ref,
                                     decode_window_attention_ref)
from repro_torch.roofline import op_walk

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DH = 256
# rows a block's tile holds, which a split is a whole number of: the
# tensor-core body (bf16) streams 64-row stages (16 rows a warp), the
# CUDA-core body (float32) 4 warps x 32 rows
_TILE_ROWS = {torch.bfloat16: 64, torch.float32: 128}
_MIN_SPLIT_ROWS = 256
_WAVE_FILL = 0.9               # bf16: the share of a wave's slots to fill
_F32_BLOCKS_PER_SM = 16        # float32: splits enough for this many blocks
_MAX_SPLITS = 256              # the kernel's merge holds a weight a split
_GROUP_HEADS = 8               # query heads a bf16 block holds at most
_PART_SHARE = 0.05             # partial bytes at most this share of K/V's
_lib = None
_sm_count: dict[int, int] = {}
_body_info: dict[tuple[int, int], dict[str, int]] = {}
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("window_attention")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.window_attention_launch.argtypes = (
            [p] * 7 + [i32] * 7 + [i64] * 6 + [i32, i32, p])
        lib.window_attention_launch.restype = ctypes.c_int
        lib.window_attention_partial_launch.argtypes = (
            [p] * 7 + [i32] * 7 + [i64] * 6 + [i32, i32, p, p, p])
        lib.window_attention_partial_launch.restype = ctypes.c_int
        lib.window_attention_info.argtypes = [i32, p]
        lib.window_attention_info.restype = ctypes.c_int
        lib.window_attention_error_string.argtypes = [ctypes.c_int]
        lib.window_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=1024)
def split_rows(n_groups: int, w: int, n_sms: int, n_rep: int = 1,
               dh: int = 128, dtype: torch.dtype = torch.bfloat16,
               resident: int = 2) -> tuple[int, int]:
    """``(chunk, n_splits)``: the rows of W each block takes, and how many
    blocks share one of the ``n_groups`` (request, KV head) pairs.

    Each split is a whole number of the body's tiles, at least
    ``_MIN_SPLIT_ROWS`` rows and long enough that the float32 partials
    the splits write and the merge reads (``dh + 2`` floats a query head)
    stay under ``_PART_SHARE`` of the K/V bytes they read; at most
    ``_MAX_SPLITS`` splits.  Within that:

    * bf16 (the tensor-core body, ``resident`` blocks an SM): the fewest
      splits whose blocks fill the ``resident * n_sms`` slots in whole
      waves to ``_WAVE_FILL`` (else as full as any split count does).  A
      full ring then streams with every block running from the first
      wave to the last, none starting late;
    * float32 (the CUDA-core body): splits enough for
      ``_F32_BLOCKS_PER_SM`` blocks an SM, short splits that balance a
      ragged kv_len.

    The split count depends on W, not on ``kv_len``, which lies on the
    card."""
    tile = _TILE_ROWS[dtype]
    groups = max(n_groups, 1)
    part = 2 * n_rep * (dh + 2) * 4      # a split's, written and read
    min_rows = max(_MIN_SPLIT_ROWS,
                   math.ceil(part / (_PART_SHARE * 2 * dh * dtype.itemsize)))
    most = max(1, min(w // min_rows, _MAX_SPLITS))

    def plan(n):
        chunk = -(-w // n)
        chunk = -(-chunk // tile) * tile
        return chunk, -(-w // chunk)

    if dtype == torch.float32:
        return plan(min(math.ceil(_F32_BLOCKS_PER_SM * n_sms / groups),
                        most))
    slots = resident * n_sms

    def fill(n):
        blocks = plan(n)[1] * groups
        return blocks / (-(-blocks // slots) * slots)
    best = max(fill(n) for n in range(1, most + 1))
    n = next(n for n in range(1, most + 1)
             if fill(n) >= min(_WAVE_FILL, best))
    return plan(n)


def _sms(device: torch.device) -> int:
    n = _sm_count.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_count[device.index] = n
    return n


def body_info(device: torch.device, dh: int) -> dict[str, int]:
    """The bf16 body's compiled attributes at this dh on ``device``
    (``window_attention_info``), cached."""
    key = (device.index, dh)
    info = _body_info.get(key)
    if info is None:
        lib = _kernel_lib()
        out = (ctypes.c_int32 * 6)()
        with torch.cuda.device(device):
            err = lib.window_attention_info(dh, out)
        if err:
            raise RuntimeError(f"window_attention_info failed: "
                               f"{lib.window_attention_error_string(err)}")
        info = dict(zip(("registers", "spill_bytes", "static_smem",
                         "dynamic_smem", "blocks_per_sm", "stages"), out))
        _body_info[key] = info
    return info


def _ticket(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The launch's zeroed int32 tickets, one buffer per device and
    stream (each launch leaves it zero again), grown when too small."""
    t = _tickets.get((device.index, stream))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[(device.index, stream)] = t
    return t


def _aligned(t: torch.Tensor, dh: int) -> bool:
    """Rows of ``t`` can be read in 16-byte pieces (the stride of a
    size-1 dimension is never used)."""
    elt = t.element_size()
    return (dh * elt % 16 == 0 and t.data_ptr() % 16 == 0
            and all(st * elt % 16 == 0 or n == 1
                    for st, n in zip(t.stride()[:3], t.shape[:3])))


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


def attention_work(rows: int, b: int, h: int, hkv: int, dh: int,
                   kv_bytes: int) -> tuple[int, int]:
    """``(bytes, flops)`` of one call over ``rows`` valid cache rows in
    all (the sum of kv_len): every valid K and V row read once per KV
    head, q in float32 and kv_len read once, the float32 output written
    once; a multiply and an add per element of q . k and of p . v, and 4
    a score for the softmax's max, exp, sum and scale."""
    nbytes = rows * hkv * 2 * dh * kv_bytes + 2 * b * h * dh * 4 + b * 4
    return nbytes, rows * h * (4 * dh + 4)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Decode attention over a KV cache; returns float32 ``[B, H, dh]``.

    q:      [B, H, dh] float (read as float32)
    k, v:   [B, W, Hkv, dh] float32 or bfloat16, unit stride in dh
    kv_len: [B] int32, 1 <= kv_len <= W (the valid prefix of W)

    ``window_attention.launches`` counts the CUDA kernel's launches.
    """
    _check_args(q, k, v, kv_len)
    if not op_walk.walking():
        return _dispatch(q, k, v, kv_len)
    b, h, dh = q.shape
    nbytes, flops = attention_work(b * k.shape[1], b, h, k.shape[2], dh,
                                   k.element_size())
    with op_walk.kernel("window_attention", flops, nbytes) as call:
        out = _dispatch(q, k, v, kv_len)
        call.outputs(out)
    return out


def window_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, kv_len: torch.Tensor):
    """The partial entry: ``(o, m, l)``, float32 ``[B, H, dh]``, ``[B,
    H]``, ``[B, H]``: m the scores' max over the first ``kv_len`` rows, l
    the sum of ``e^(s - m)`` and o the sum of ``e^(s - m) v``; ``0 <=
    kv_len <= W``, and a request with no row gives ``(0, -inf, 0)``.
    Its launches count in ``window_attention.launches``."""
    _check_args(q, k, v, kv_len)
    if not op_walk.walking():
        return _dispatch(q, k, v, kv_len, partial=True)
    b, h, dh = q.shape
    nbytes, flops = attention_work(b * k.shape[1], b, h, k.shape[2], dh,
                                   k.element_size())
    # the same kernel as ``window_attention``, with m and l written too
    with op_walk.kernel("window_attention", flops,
                        nbytes + 2 * b * h * 4) as call:
        out = _dispatch(q, k, v, kv_len, partial=True)
        call.outputs(*out)
    return out


def _dispatch(q, k, v, kv_len, partial: bool = False):
    device = q.device
    if device.type == "cpu":
        if partial:
            return decode_window_attention_partial_ref(q, k, v, kv_len)
        return decode_window_attention_ref(q, k, v, kv_len)
    if device.type == "meta":
        out = torch.empty(q.shape, dtype=torch.float32, device=device)
        if partial:
            return (out,) + tuple(torch.empty(q.shape[:2],
                                              dtype=torch.float32,
                                              device=device)
                                  for _ in range(2))
        return out
    if device.type != "cuda":
        raise ValueError(f"window_attention runs on cuda, cpu or meta, not "
                         f"{device}")
    b, h, dh = q.shape
    w, hkv = k.shape[1], k.shape[2]
    if dh > _MAX_DH:
        raise ValueError(f"the kernel takes dh <= {_MAX_DH}, got {dh}")
    if k.stride(3) != 1 or v.stride(3) != 1 or not kv_len.is_contiguous():
        raise ValueError("k and v need a unit stride in dh, kv_len must be "
                         "contiguous")
    out = torch.empty((b, h, dh), dtype=torch.float32, device=device)
    row = (torch.empty((2, b, h), dtype=torch.float32, device=device)
           if partial else None)
    if b == 0 or h == 0:
        return (out, row[0], row[1]) if partial else out
    q = q.to(torch.float32).contiguous()
    n_rep = h // hkv
    n_chunks = -(-n_rep // _GROUP_HEADS)
    resident = (body_info(device, dh)["blocks_per_sm"]
                if k.dtype == torch.bfloat16 else 0)
    chunk, n_splits = split_rows(b * hkv * n_chunks, w, _sms(device),
                                 -(-n_rep // n_chunks), dh, k.dtype,
                                 resident)
    # bf16 copies K and V in 16-byte pieces, float32 reads K so
    vec = _aligned(k, dh) and (k.dtype == torch.float32 or _aligned(v, dh))
    # the partials acc [B, H, n_splits, dh], m and l [B, H, n_splits]; one
    # split writes its output directly
    part = torch.empty(b * h * n_splits * (dh + 2) if n_splits > 1 else 0,
                       dtype=torch.float32, device=device)
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    ticket = _ticket(device, stream, b * h)
    with torch.cuda.device(device):
        err = lib.window_attention_partial_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            part.data_ptr(), ticket.data_ptr(), out.data_ptr(), b, h, hkv,
            w, dh, chunk, n_splits, k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), _DTYPE_CODE[k.dtype],
            int(vec), row[0].data_ptr() if partial else None,
            row[1].data_ptr() if partial else None, stream)
    if err:
        raise RuntimeError(
            f"window_attention launch failed (q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, {n_splits} splits of {chunk} rows): "
            f"{lib.window_attention_error_string(err).decode()}")
    window_attention.launches += 1
    return (out, row[0], row[1]) if partial else out


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
