"""ALS normal-equation accumulation: the CUDA kernel's wrappers and its
plain version.

Per row v with neighbour factors ``X_j = x[nbrs[v, j]]``:

    A[v] = sum_j m[v,j] * X_j X_j^T        [d, d]
    b[v] = sum_j m[v,j] * r[v,j] * X_j     [d]

is the deg-bound half of the ALS update (paper §5.1); the d^3 solve
stays outside.  ``als_normal_eq`` is the one launch;
``als_normal_eq_bucketed`` (one launch per degree bucket),
``als_normal_eq_batched`` (one ``[B, W]`` window launch) and
``als_normal_eq_fold`` (already-gathered scope values through the
identity gather, the ALS update's form) all go through it, as in the
reference.

On a CUDA tensor the wrapper launches ``csrc/als_normal_eq.cu`` (built
at first use, see ``_build``) or raises; on a CPU tensor it runs
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

import torch

from repro_torch.kernels import _build

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("als_normal_eq")
        p = ctypes.c_void_p
        lib.als_normal_eq_launch.argtypes = [p, p, p, p, p, p, ctypes.c_int64,
                                             ctypes.c_int32, ctypes.c_int64,
                                             ctypes.c_int32, p]
        lib.als_normal_eq_launch.restype = ctypes.c_int
        lib.als_normal_eq_error_string.argtypes = [ctypes.c_int]
        lib.als_normal_eq_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def als_normal_eq_plain(nbrs: torch.Tensor, mask: torch.Tensor,
                        ratings: torch.Tensor, x: torch.Tensor):
    """The kernel's function, as an eager slot loop in the kernel's
    order and rounding (the CPU path, and the kernel's yardstick)."""
    nv, width = nbrs.shape
    d = x.shape[1]
    idx = nbrs.long().clamp(0, max(x.shape[0] - 1, 0))
    a = torch.zeros((nv, d, d), dtype=torch.float32, device=x.device)
    b = torch.zeros((nv, d), dtype=torch.float32, device=x.device)
    for j in range(width):
        m = mask[:, j]
        xi = x[idx[:, j]]                                  # [Nv, d]
        xm = xi * m.to(x.dtype)[:, None]
        a = torch.where(m[:, None, None], a + xm[:, :, None] * xi[:, None, :],
                        a)
        b = torch.where(m[:, None], b + xm * ratings[:, j, None], b)
    return a, b


def _check_args(nbrs, mask, ratings, x):
    if nbrs.dim() != 2 or nbrs.dtype != torch.int32:
        raise ValueError(f"nbrs must be a 2-D int32 tensor, got "
                         f"{tuple(nbrs.shape)} {nbrs.dtype}")
    if mask.shape != nbrs.shape or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool {tuple(nbrs.shape)}, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if ratings.shape != nbrs.shape:
        raise ValueError(f"ratings {tuple(ratings.shape)} must match nbrs "
                         f"{tuple(nbrs.shape)}")
    if x.dtype != torch.float32 or ratings.dtype != torch.float32:
        raise ValueError(f"als_normal_eq takes float32 x and ratings, got "
                         f"{x.dtype}, {ratings.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D [R, d], got {tuple(x.shape)}")
    if x.shape[0] == 0 and nbrs.numel():
        raise ValueError("x has no rows to gather from")


def _check_contiguous(nbrs, mask, ratings, x):
    for name, t in (("nbrs", nbrs), ("mask", mask), ("ratings", ratings),
                    ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def als_normal_eq(nbrs: torch.Tensor, mask: torch.Tensor,
                  ratings: torch.Tensor, x: torch.Tensor):
    """Returns ``(A [Nv, d, d], b [Nv, d])``; the caller adds the ridge
    and solves.

    nbrs:    [Nv, W] int32
    mask:    [Nv, W] bool — only real slots contribute
    ratings: [Nv, W] float32
    x:       [R, d]  float32 (gather source), 1 <= d <= 64 on the card

    ``als_normal_eq.launches`` counts the CUDA kernel's launches.
    """
    devices = {t.device for t in (nbrs, mask, ratings, x)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    _check_args(nbrs, mask, ratings, x)
    device = x.device
    if device.type == "cpu":
        return als_normal_eq_plain(nbrs, mask, ratings, x)
    if device.type != "cuda":
        raise ValueError(f"als_normal_eq runs on cuda or cpu, not {device}")
    _check_contiguous(nbrs, mask, ratings, x)
    nv, width = nbrs.shape
    d = x.shape[1]
    a = torch.empty((nv, d, d), dtype=torch.float32, device=device)
    b = torch.empty((nv, d), dtype=torch.float32, device=device)
    if nv == 0 or d == 0:
        return a, b
    lib = _kernel_lib()
    with torch.cuda.device(device):
        err = lib.als_normal_eq_launch(
            nbrs.data_ptr(), mask.data_ptr(), ratings.data_ptr(),
            x.data_ptr(), a.data_ptr(), b.data_ptr(), nv, width, x.shape[0],
            d, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(
            f"als_normal_eq launch failed ([{nv}, {width}] slots, d={d}; "
            f"the kernel takes 1 <= d <= 64): "
            f"{lib.als_normal_eq_error_string(err).decode()}")
    als_normal_eq.launches += 1
    return a, b


als_normal_eq.launches = 0


def als_normal_eq_bucketed(nbrs_blocks, mask_blocks, ratings_blocks,
                           x: torch.Tensor):
    """Sliced-ELL normal equations: one width-specialized launch per
    degree bucket (mirrors ``ell_spmv_bucketed``), so the work is the
    sliced slot count instead of ``Nv * max_deg``.  Returns
    ``(A [sum Nv_b, d, d], b [sum Nv_b, d])`` in bucketed row order."""
    d = x.shape[1]
    As, bs = [], []
    for nb, mk, rt in zip(nbrs_blocks, mask_blocks, ratings_blocks):
        if nb.shape[0] == 0:
            As.append(x.new_zeros((0, d, d)))
            bs.append(x.new_zeros((0, d)))
            continue
        a, b = als_normal_eq(nb, mk, rt, x)
        As.append(a)
        bs.append(b)
    return torch.cat(As, dim=0), torch.cat(bs, dim=0)


def als_normal_eq_batched(nbrs: torch.Tensor, mask: torch.Tensor,
                          ratings: torch.Tensor, x: torch.Tensor):
    """Window-shaped normal equations: one ``[B, W]`` launch over a
    gathered scope (mirrors ``ell_spmv_batched``).  Delegates to the
    shared launch, so a fold of the same window stays bitwise equal."""
    return als_normal_eq(nbrs, mask, ratings, x)


def als_normal_eq_fold(mask: torch.Tensor, ratings: torch.Tensor,
                       X: torch.Tensor):
    """The normal equations of already-gathered scope values
    ``X [B, D, d]`` (the ALS update's dense scope), through the identity
    gather ``idx[b, j] = b*D + j``, as ``ell_fold`` does.  ``X`` is
    passed unmasked, as a view; the kernel masks."""
    b, d_slots, d = X.shape
    if b * d_slots > torch.iinfo(torch.int32).max:
        raise ValueError(f"[{b}, {d_slots}] slots overflow the int32 "
                         "identity gather")
    idx = (torch.arange(b, dtype=torch.int32, device=X.device)[:, None]
           * d_slots
           + torch.arange(d_slots, dtype=torch.int32, device=X.device))
    return als_normal_eq(idx, mask, ratings, X.reshape(b * d_slots, d))
