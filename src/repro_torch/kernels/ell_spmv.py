"""Sliced-ELL neighbour aggregation: the CUDA kernel's wrappers and its
plain version.

    y[v, :] = row_mask[v] * sum_j  w[v, j] * x[nbrs[v, j], :]

is the inner loop of every sweep-style update (PageRank, CoEM, the BSP
baselines).  Every entry point goes through one table launch of
``csrc/ell_spmv.cu`` (``[Nv_b, W_b]`` blocks, at most ``MAX_BUCKETS``
non-empty ones a launch; a call with more is split into launches of
consecutive buckets, each writing its own rows of the one output):
``ell_spmv_bucketed`` (a whole degree-bucket sweep) and
``ell_fold_bucketed`` (the dense arm's per-bucket folds) pass one entry a
bucket, ``ell_spmv``, ``ell_spmv_batched`` (a ``[B, W]`` window) and
``ell_fold`` (a reduction of pre-gathered scope values through the
identity gather) pass one.  That shared body is what keeps the engines'
dense fallback bitwise equal to their kernel path: both reduce with one
accumulation.

On a CUDA tensor the wrapper launches the kernel (built at first use,
see ``_build``) or raises; on a CPU tensor it runs ``ell_spmv_plain``, an
eager slot loop with the kernel's arithmetic: slots in order, each
product rounded in the input dtype and widened to float32, a float32
accumulator, the weight gated by the row mask first.  Out-of-range
neighbour ids read the nearest row in both, as XLA's gather clamps in
the reference.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's geometry (ELL_TILE, ELL_THREADS, ELL_MAX_BUCKETS in
# csrc/ell_spmv.cu); checked against the built library when it loads
TILE = 2048            # virtual slots a block gathers in one pass (F = 1)
THREADS = 256
MAX_BUCKETS = 16       # non-empty buckets one launch takes (PageRank has 8)
_lib = None


class _Bucket(ctypes.Structure):
    """``struct Bucket`` of csrc/ell_spmv.cu."""
    _fields_ = [("nbrs", ctypes.c_void_p), ("w", ctypes.c_void_p),
                ("mask", ctypes.c_void_p), ("x", ctypes.c_void_p),
                ("n_src", ctypes.c_int64), ("n_rows", ctypes.c_int64),
                ("out_row", ctypes.c_int64), ("block_start", ctypes.c_int64),
                ("width", ctypes.c_int32), ("lg_group", ctypes.c_int32),
                ("mask_kind", ctypes.c_int32), ("pad", ctypes.c_int32)]


class _Table(ctypes.Structure):
    """``struct Table`` of csrc/ell_spmv.cu."""
    _fields_ = [("b", _Bucket * MAX_BUCKETS), ("n", ctypes.c_int32)]


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("ell_spmv")
        p = ctypes.c_void_p
        lib.ell_spmv_launch.argtypes = [p, ctypes.c_int64, p, ctypes.c_int32,
                                        ctypes.c_int32, p]
        lib.ell_spmv_launch.restype = ctypes.c_int
        lib.ell_spmv_geometry.argtypes = [p, p, p, p]
        lib.ell_spmv_geometry.restype = None
        lib.ell_spmv_error_string.argtypes = [ctypes.c_int]
        lib.ell_spmv_error_string.restype = ctypes.c_char_p
        got = [ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32(),
               ctypes.c_int64()]
        lib.ell_spmv_geometry(*(ctypes.byref(g) for g in got))
        got = tuple(g.value for g in got)
        want = (TILE, THREADS, MAX_BUCKETS, ctypes.sizeof(_Table))
        if got != want:
            raise RuntimeError(f"csrc/ell_spmv.cu was built for (tile, "
                               f"threads, buckets, table bytes) {got}, the "
                               f"wrapper plans for {want}")
        _lib = lib
    return _lib


def ell_spmv_plain(nbrs: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                   row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function, as an eager slot loop in the kernel's
    order and rounding (the CPU path, and the kernel's yardstick)."""
    nv, d = nbrs.shape
    if row_mask is not None:
        w = w * row_mask.to(w.dtype)[:, None]
    idx = nbrs.long().clamp(0, max(x.shape[0] - 1, 0))
    acc = torch.zeros((nv, x.shape[1]), dtype=torch.float32, device=x.device)
    for j in range(d):
        acc += (w[:, j:j + 1] * x[idx[:, j]]).to(torch.float32)
    return acc.to(x.dtype)


@functools.lru_cache(maxsize=256)
def plan_table(shapes: tuple[tuple[int, int], ...], n_feat: int, tile: int,
               threads: int) -> tuple[tuple[tuple[int, int, int, int], ...],
                                      int]:
    """The block plan of one launch over buckets of ``(rows, width)``
    ``shapes`` (in the caller's order, which is the output's row order).

    Returns ``(entries, n_blocks)``: one ``(bucket, lg_group,
    block_start, out_row)`` per non-empty bucket, in launch order (the
    widest first, so the blocks with the longest serial sums start
    first), and the grid size.  At F = 1 a bucket of width W takes
    groups of ``G = next_pow2(W)`` virtual slots (at most ``tile``;
    ``lg_group = log2 G``) and ``tile // G`` rows a block; at F > 1 a
    block takes ``threads`` output elements.
    """
    out_rows, row = [], 0
    for nv, _ in shapes:
        out_rows.append(row)
        row += nv
    order = sorted((b for b, (nv, _) in enumerate(shapes) if nv > 0),
                   key=lambda b: -shapes[b][1])
    entries, start = [], 0
    for b in order:
        nv, width = shapes[b]
        lg = min(max(width - 1, 0).bit_length(), tile.bit_length() - 1)
        if n_feat == 1:
            blocks = -(-nv // (tile >> lg))
        else:
            blocks = -(-nv * n_feat // threads)
        entries.append((b, lg, start, out_rows[b]))
        start += blocks
    return tuple(entries), start


@functools.lru_cache(maxsize=256)
def split_table(shapes: tuple[tuple[int, ...], ...],
                limit: int) -> tuple[tuple[int, int, int], ...]:
    """The launches of one call over buckets of ``(rows, ...)`` ``shapes``:
    runs ``(lo, hi, row0)`` of consecutive buckets ``lo:hi``, each holding
    at most ``limit`` non-empty buckets, whose output rows start at
    ``row0`` (the buckets' rows one after another in the caller's order).
    Empty buckets ride in the run around them; a call with no non-empty
    bucket makes no launch."""
    runs, lo, row0, row, count = [], 0, 0, 0, 0
    for b, (nv, *_) in enumerate(shapes):
        if nv > 0 and count == limit:
            runs.append((lo, b, row0))
            lo, row0, count = b, row, 0
        count += nv > 0
        row += nv
    if count:
        runs.append((lo, len(shapes), row0))
    return tuple(runs)


def _check_cuda_args(nbrs, w, x, row_mask):
    if nbrs.dim() != 2 or nbrs.dtype != torch.int32:
        raise ValueError(f"nbrs must be a 2-D int32 tensor, got "
                         f"{tuple(nbrs.shape)} {nbrs.dtype}")
    if w.shape != nbrs.shape:
        raise ValueError(f"w {tuple(w.shape)} must match nbrs "
                         f"{tuple(nbrs.shape)}")
    if w.dtype not in _DTYPE_CODE or x.dtype != w.dtype:
        raise ValueError(f"w and x must share a dtype in "
                         f"{list(_DTYPE_CODE)}, got {w.dtype}, {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D [R, F], got {tuple(x.shape)}")
    if x.shape[0] == 0 and nbrs.numel():
        raise ValueError("x has no rows to gather from")
    if row_mask is not None and row_mask.shape != (nbrs.shape[0],):
        raise ValueError(f"row_mask must be [{nbrs.shape[0]}], got "
                         f"{tuple(row_mask.shape)}")
    for name, t in (("nbrs", nbrs), ("w", w), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_table(items):
    """Checks every bucket of a call; returns its feature count."""
    for it in items:
        _check_cuda_args(*it)
    x0 = items[0][2]
    for _, _, x, _ in items:
        if x.dtype != x0.dtype or x.shape[1] != x0.shape[1]:
            raise ValueError(f"every bucket's x must share a dtype and a "
                             f"feature count, got {x0.dtype} "
                             f"{tuple(x0.shape)} and {x.dtype} "
                             f"{tuple(x.shape)}")
    return x0.shape[1]


def build_table(items, n_feat: int):
    """The launch's ``_Table`` for buckets ``items = [(nbrs, w, x,
    row_mask)]``, its grid size, and the tensors it points to (kept
    alive by the caller until the launch is enqueued).  A bool row mask
    is read as bytes 0/1; any other mask is cast to w's dtype once."""
    entries, n_blocks = plan_table(
        tuple(tuple(it[0].shape) for it in items), n_feat, TILE, THREADS)
    if len(entries) > MAX_BUCKETS:
        raise ValueError(f"one launch takes at most {MAX_BUCKETS} non-empty "
                         f"buckets, got {len(entries)}")
    table, keep = _Table(), []
    table.n = len(entries)
    for i, (b, lg, start, out_row) in enumerate(entries):
        nbrs, w, x, mask = items[b]
        kind, mptr = 0, None
        if mask is not None:
            kind = 1 if mask.dtype == torch.bool else 2
            mask = mask.contiguous() if kind == 1 \
                else mask.to(w.dtype).contiguous()
            keep.append(mask)
            mptr = mask.data_ptr()
        table.b[i] = _Bucket(nbrs.data_ptr(), w.data_ptr(), mptr,
                             x.data_ptr(), x.shape[0], nbrs.shape[0],
                             out_row, start, nbrs.shape[1], lg, kind, 0)
    return table, n_blocks, keep


def _spmv_table(items) -> torch.Tensor:
    """``torch.cat([ell_spmv(*it) for it in items])`` on a CUDA device in
    ``ceil(n / MAX_BUCKETS)`` launches for ``n`` non-empty buckets, each
    writing its rows of the one output (the plain version, bucket by
    bucket, on the CPU)."""
    tensors = [t for it in items for t in it if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        ys = [ell_spmv_plain(*it) for it in items]
        return ys[0] if len(ys) == 1 else torch.cat(ys, dim=0)
    if device.type != "cuda":
        raise ValueError(f"ell_spmv runs on cuda or cpu, not {device}")
    n_feat = _check_table(items)
    x0 = items[0][2]
    y = torch.empty((sum(it[0].shape[0] for it in items), n_feat),
                    dtype=x0.dtype, device=device)
    if y.numel() == 0:
        return y
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    for lo, hi, row0 in split_table(
            tuple(tuple(it[0].shape) for it in items), MAX_BUCKETS):
        table, n_blocks, keep = build_table(items[lo:hi], n_feat)
        with torch.cuda.device(device):
            err = lib.ell_spmv_launch(
                ctypes.byref(table), n_blocks, y[row0:].data_ptr(), n_feat,
                _DTYPE_CODE[x0.dtype], stream)
        del keep
        if err:
            raise RuntimeError(f"ell_spmv launch failed: "
                               f"{lib.ell_spmv_error_string(err).decode()}")
        ell_spmv.launches += 1
    return y


def ell_spmv(nbrs: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
             row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """y[v] = row_mask[v] * sum_j w[v, j] * x[nbrs[v, j]].

    nbrs:     [Nv, W] int32 (padded slots may point anywhere; w must be 0)
    w:        [Nv, W] float32 or bfloat16
    x:        [R, F]  same dtype as w (gather source)
    row_mask: [Nv] bool/float or None — rows with a falsy mask yield 0
    returns y: [Nv, F] in x's dtype

    ``ell_spmv.launches`` counts the CUDA kernel's launches: one for each
    call of any entry point, and one more for every ``MAX_BUCKETS``
    non-empty buckets beyond the first.
    """
    return _spmv_table([(nbrs, w, x, row_mask)])


ell_spmv.launches = 0


def ell_spmv_bucketed(nbrs_blocks, w_blocks, x: torch.Tensor,
                      row_masks=None) -> torch.Tensor:
    """Sliced-ELL SpMV: every degree bucket in one launch (one for each
    ``MAX_BUCKETS`` non-empty buckets).

    Returns ``y [sum_b Nv_b, F]`` in bucketed row order (the blocks'
    rows one after another); callers translate through the
    ``SlicedEll`` permutation.
    """
    items = [(nb, w, x, None if row_masks is None else row_masks[b])
             for b, (nb, w) in enumerate(zip(nbrs_blocks, w_blocks))]
    if not items:
        return x.new_zeros((0, x.shape[1]))
    return _spmv_table(items)


def ell_spmv_batched(nbrs: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                     row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Window-shaped SpMV: one ``[B, W]`` launch over a gathered scope.
    Delegates to the shared launch, so a dense fold of the same window
    through ``ell_fold`` stays bitwise equal to it."""
    return ell_spmv(nbrs, w, x, row_mask=row_mask)


def _identity_gather(b: int, d: int, device) -> torch.Tensor:
    """``idx[i, j] = i*d + j``: slot j of row i reads vals row i*d + j."""
    return (torch.arange(b, dtype=torch.int32, device=device)[:, None] * d
            + torch.arange(d, dtype=torch.int32, device=device)[None, :])


def ell_fold_bucketed(w_blocks, v_blocks, row_masks=None) -> torch.Tensor:
    """``ell_fold`` of every bucket in one launch (one for each
    ``MAX_BUCKETS`` non-empty buckets): y[b] = sum_j w[b, j] *
    vals[b, j] for each ``(w [B_b, D_b], vals [B_b, D_b, F])``, rows of
    the buckets one after another."""
    items = []
    for b, (w, vals) in enumerate(zip(w_blocks, v_blocks)):
        nb, d, f = vals.shape
        items.append((_identity_gather(nb, d, vals.device), w,
                      vals.reshape(nb * d, f),
                      None if row_masks is None else row_masks[b]))
    return _spmv_table(items)


def ell_fold(w: torch.Tensor, vals: torch.Tensor,
             row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """y[b] = sum_j w[b, j] * vals[b, j]: the kernel's reduction applied
    to already-materialized scope values ``vals [B, D, F]``, through the
    identity gather ``idx[b, j] = b*D + j``."""
    return ell_fold_bucketed([w], [vals],
                             None if row_mask is None else [row_mask])
