"""ALS normal-equation accumulation: the CUDA kernel's wrappers and its
plain version.

Per row v with neighbour factors ``X_j = x[nbrs[v, j]]``:

    A[v] = sum_j m[v,j] * X_j X_j^T        [d, d]
    b[v] = sum_j m[v,j] * r[v,j] * X_j     [d]

is the deg-bound half of the ALS update (paper §5.1); the d^3 solve
stays outside.  Every entry point goes through one table launch of
``csrc/als_normal_eq.cu`` (``[Nv_b, W_b]`` blocks, at most
``MAX_BUCKETS`` non-empty ones a launch; a call with more is split into
launches of consecutive buckets, each writing its own rows of the one
output), as in the reference: ``als_normal_eq_bucketed`` passes one
entry a degree bucket, ``als_normal_eq``, ``als_normal_eq_batched`` (a
``[B, W]`` window) and ``als_normal_eq_fold`` (already-gathered scope
values, the ALS update's form) pass one.  The fold passes no index: the
kernel reads slot j of row b at row ``b*D + j`` of the scope.

On a CUDA tensor the wrapper launches the kernel (built at first use,
see ``_build``) or raises; on a CPU tensor it runs
``als_normal_eq_plain``, an eager slot loop with the kernel's
arithmetic: slots in order, ``xm = x * m`` rounded first, then each
product rounded before it is added to a float32 accumulator, and masked
slots skipped (for finite x that is bitwise the reference's multiply by
0).  Float32 only: the reference accumulates in x's dtype, and a
bfloat16 kernel is ROADMAP B3's later work.  Out-of-range neighbour ids
read the nearest row in both, as XLA's gather clamps in the reference.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_spmv import split_table

# ALS_MAX_BUCKETS of csrc/als_normal_eq.cu; checked against the built
# library when it loads
MAX_BUCKETS = 16       # non-empty buckets one launch takes
_lib = None


class _Bucket(ctypes.Structure):
    """``struct AlsBucket`` of csrc/als_normal_eq.cu."""
    _fields_ = [("nbrs", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("ratings", ctypes.c_void_p), ("x", ctypes.c_void_p),
                ("n_src", ctypes.c_int64), ("n_rows", ctypes.c_int64),
                ("out_row", ctypes.c_int64), ("block_start", ctypes.c_int64),
                ("width", ctypes.c_int32), ("pad", ctypes.c_int32)]


class _Table(ctypes.Structure):
    """``struct AlsTable`` of csrc/als_normal_eq.cu."""
    _fields_ = [("b", _Bucket * MAX_BUCKETS), ("n", ctypes.c_int32)]


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("als_normal_eq")
        p, i32 = ctypes.c_void_p, ctypes.c_int32
        lib.als_normal_eq_launch.argtypes = [p, ctypes.c_int64, i32, p, p, p]
        lib.als_normal_eq_launch.restype = ctypes.c_int
        lib.als_normal_eq_geometry.argtypes = [i32, p, p, p, p, p]
        lib.als_normal_eq_geometry.restype = ctypes.c_int
        lib.als_normal_eq_error_string.argtypes = [ctypes.c_int]
        lib.als_normal_eq_error_string.restype = ctypes.c_char_p
        got = [ctypes.c_int32() for _ in range(4)] + [ctypes.c_int64()]
        lib.als_normal_eq_geometry(1, *(ctypes.byref(g) for g in got))
        got = (got[3].value, got[4].value)
        want = (MAX_BUCKETS, ctypes.sizeof(_Table))
        if got != want:
            raise RuntimeError(f"csrc/als_normal_eq.cu was built for (buckets, "
                               f"table bytes) {got}, the wrapper plans for "
                               f"{want}")
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def geometry(d: int) -> tuple[int, int, int]:
    """``(warps a row, rows a block, mask window)`` of the built kernel at
    feature width d; raises outside 1 <= d <= 64."""
    lib = _kernel_lib()
    got = [ctypes.c_int32() for _ in range(4)] + [ctypes.c_int64()]
    err = lib.als_normal_eq_geometry(d, *(ctypes.byref(g) for g in got))
    if err:
        raise RuntimeError(
            f"als_normal_eq launch failed (d={d}; the kernel takes 1 <= d "
            f"<= 64): {lib.als_normal_eq_error_string(err).decode()}")
    return got[0].value, got[1].value, got[2].value


def als_normal_eq_plain(nbrs: torch.Tensor | None, mask: torch.Tensor,
                        ratings: torch.Tensor, x: torch.Tensor):
    """The kernel's function, as an eager slot loop in the kernel's
    order and rounding (the CPU path, and the kernel's yardstick).
    ``nbrs=None`` is the identity gather: x is ``[Nv * W, d]``."""
    nv, width = mask.shape
    d = x.shape[1]
    if nbrs is None:
        rows = x.reshape(nv, width, d)
    else:
        idx = nbrs.long().clamp(0, max(x.shape[0] - 1, 0))
    a = torch.zeros((nv, d, d), dtype=torch.float32, device=x.device)
    b = torch.zeros((nv, d), dtype=torch.float32, device=x.device)
    for j in range(width):
        m = mask[:, j]
        xi = rows[:, j] if nbrs is None else x[idx[:, j]]   # [Nv, d]
        xm = xi * m.to(x.dtype)[:, None]
        a = torch.where(m[:, None, None], a + xm[:, :, None] * xi[:, None, :],
                        a)
        b = torch.where(m[:, None], b + xm * ratings[:, j, None], b)
    return a, b


@functools.lru_cache(maxsize=256)
def plan_table(shapes: tuple[tuple[int, int], ...], rows_per_block: int
               ) -> tuple[tuple[tuple[int, int, int], ...], int]:
    """The block plan of one launch over buckets of ``(rows, width)``
    ``shapes`` (in the caller's order, which is the output's row order).

    Returns ``(entries, n_blocks)``: one ``(bucket, block_start,
    out_row)`` per non-empty bucket, in launch order (the widest first,
    so the blocks with the longest serial sums start first; ties in the
    caller's order), and the grid size.  A bucket of Nv rows takes
    ``ceil(Nv / rows_per_block)`` blocks.
    """
    out_rows, row = [], 0
    for nv, _ in shapes:
        out_rows.append(row)
        row += nv
    order = sorted((b for b, (nv, _) in enumerate(shapes) if nv > 0),
                   key=lambda b: -shapes[b][1])
    entries, start = [], 0
    for b in order:
        entries.append((b, start, out_rows[b]))
        start += -(-shapes[b][0] // rows_per_block)
    return tuple(entries), start


def _check_args(nbrs, mask, ratings, x):
    if nbrs is not None and (nbrs.dim() != 2 or nbrs.dtype != torch.int32):
        raise ValueError(f"nbrs must be a 2-D int32 tensor, got "
                         f"{tuple(nbrs.shape)} {nbrs.dtype}")
    shape = mask.shape if nbrs is None else nbrs.shape
    if mask.dim() != 2 or mask.shape != shape or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool {tuple(shape)}, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if ratings.shape != shape:
        raise ValueError(f"ratings {tuple(ratings.shape)} must match nbrs "
                         f"{tuple(shape)}")
    if x.dtype != torch.float32 or ratings.dtype != torch.float32:
        raise ValueError(f"als_normal_eq takes float32 x and ratings, got "
                         f"{x.dtype}, {ratings.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D [R, d], got {tuple(x.shape)}")
    if nbrs is None and x.shape[0] != mask.numel():
        raise ValueError(f"the identity gather reads x as [Nv * W, d] = "
                         f"[{mask.numel()}, d], got {tuple(x.shape)}")
    if x.shape[0] == 0 and mask.numel():
        raise ValueError("x has no rows to gather from")


def _check_contiguous(nbrs, mask, ratings, x):
    for name, t in (("nbrs", nbrs), ("mask", mask), ("ratings", ratings),
                    ("x", x)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def build_table(items, rows_per_block: int):
    """The launch's ``_Table`` for buckets ``items = [(nbrs or None,
    mask, ratings, x)]`` and its grid size."""
    entries, n_blocks = plan_table(
        tuple(tuple(it[1].shape) for it in items), rows_per_block)
    if len(entries) > MAX_BUCKETS:
        raise ValueError(f"one launch takes at most {MAX_BUCKETS} non-empty "
                         f"buckets, got {len(entries)}")
    table = _Table()
    table.n = len(entries)
    for i, (bk, start, out_row) in enumerate(entries):
        nbrs, mask, ratings, x = items[bk]
        table.b[i] = _Bucket(None if nbrs is None else nbrs.data_ptr(),
                             mask.data_ptr(), ratings.data_ptr(),
                             x.data_ptr(), x.shape[0], mask.shape[0],
                             out_row, start, mask.shape[1], 0)
    return table, n_blocks


def _normal_eq_table(items):
    """``(A, b)`` of every item's rows, one item after another: on a CUDA
    device in one launch for each ``MAX_BUCKETS`` non-empty items, each
    writing its rows of the one output (the plain version, item by item,
    on the CPU)."""
    devices = {t.device for it in items for t in it if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    for it in items:
        _check_args(*it)
    d = items[0][3].shape[1]                 # the callers share one x
    device = devices.pop()
    if device.type == "cpu":
        parts = [als_normal_eq_plain(*it) for it in items]
        if len(parts) == 1:
            return parts[0]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    if device.type != "cuda":
        raise ValueError(f"als_normal_eq runs on cuda or cpu, not {device}")
    for it in items:
        _check_contiguous(*it)
    nv = sum(it[1].shape[0] for it in items)
    a = torch.empty((nv, d, d), dtype=torch.float32, device=device)
    b = torch.empty((nv, d), dtype=torch.float32, device=device)
    runs = split_table(tuple(tuple(it[1].shape) for it in items), MAX_BUCKETS)
    if d == 0 or not runs:
        return a, b
    rows_per_block = geometry(d)[1]
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    for lo, hi, row0 in runs:
        table, n_blocks = build_table(items[lo:hi], rows_per_block)
        with torch.cuda.device(device):
            err = lib.als_normal_eq_launch(
                ctypes.byref(table), n_blocks, d, a[row0:].data_ptr(),
                b[row0:].data_ptr(), stream)
        if err:
            raise RuntimeError(
                f"als_normal_eq launch failed ({hi - lo} buckets, d={d}): "
                f"{lib.als_normal_eq_error_string(err).decode()}")
        als_normal_eq.launches += 1
    return a, b


def als_normal_eq(nbrs: torch.Tensor, mask: torch.Tensor,
                  ratings: torch.Tensor, x: torch.Tensor):
    """Returns ``(A [Nv, d, d], b [Nv, d])``; the caller adds the ridge
    and solves.

    nbrs:    [Nv, W] int32
    mask:    [Nv, W] bool — only real slots contribute
    ratings: [Nv, W] float32
    x:       [R, d]  float32 (gather source), 1 <= d <= 64 on the card

    ``als_normal_eq.launches`` counts the CUDA kernel's launches: one for
    each call of any entry point, and one more for every ``MAX_BUCKETS``
    non-empty buckets beyond the first.
    """
    if nbrs is None:
        raise ValueError("nbrs must be a 2-D int32 tensor, got None "
                         "(als_normal_eq_fold takes gathered rows)")
    return _normal_eq_table([(nbrs, mask, ratings, x)])


als_normal_eq.launches = 0


def als_normal_eq_bucketed(nbrs_blocks, mask_blocks, ratings_blocks,
                           x: torch.Tensor):
    """Sliced-ELL normal equations: every degree bucket in one launch
    (one for each ``MAX_BUCKETS`` non-empty buckets; mirrors
    ``ell_spmv_bucketed``), so the work is the sliced slot count instead
    of ``Nv * max_deg``.  Returns ``(A [sum Nv_b, d, d], b [sum Nv_b,
    d])`` in bucketed row order."""
    items = list(zip(nbrs_blocks, mask_blocks, ratings_blocks))
    if not items:
        d = x.shape[1]
        return x.new_zeros((0, d, d)), x.new_zeros((0, d))
    if any(nb is None for nb, _, _ in items):
        raise ValueError("every bucket needs its nbrs")
    return _normal_eq_table([(nb, mk, rt, x) for nb, mk, rt in items])


def als_normal_eq_batched(nbrs: torch.Tensor, mask: torch.Tensor,
                          ratings: torch.Tensor, x: torch.Tensor):
    """Window-shaped normal equations: one ``[B, W]`` launch over a
    gathered scope (mirrors ``ell_spmv_batched``).  Delegates to the
    shared launch, so a fold of the same window stays bitwise equal."""
    return als_normal_eq(nbrs, mask, ratings, x)


def als_normal_eq_fold(mask: torch.Tensor, ratings: torch.Tensor,
                       X: torch.Tensor):
    """The normal equations of already-gathered scope values
    ``X [B, D, d]`` (the ALS update's dense scope): the kernel reads slot
    j of row b at row ``b*D + j`` of ``X`` viewed as ``[B*D, d]``, with
    no index, as ``ell_fold``'s identity gather does.  ``X`` is passed
    unmasked and in place (on the card it must be contiguous); the
    kernel masks."""
    if X.dim() != 3:
        raise ValueError(f"X must be [B, D, d], got {tuple(X.shape)}")
    b, d_slots, d = X.shape
    if X.device.type == "cuda" and not X.is_contiguous():
        raise ValueError("X must be contiguous: the fold reads it in place")
    return _normal_eq_table([(None, mask, ratings, X.reshape(b * d_slots, d))])
