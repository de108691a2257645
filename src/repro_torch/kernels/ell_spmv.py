"""Sliced-ELL neighbour aggregation: the CUDA kernel's wrappers and its
plain version.

    y[v, :] = row_mask[v] * sum_j  w[v, j] * x[nbrs[v, j], :]

is the inner loop of every sweep-style update (PageRank, CoEM, the BSP
baselines).  ``ell_spmv`` is the one launch; ``ell_spmv_bucketed`` (one
launch per degree bucket), ``ell_spmv_batched`` (one ``[B, W]`` window
launch) and ``ell_fold`` (a reduction of pre-gathered scope values
through the identity gather) all go through it, as in the reference.
That shared launch is what keeps the engines' dense fallback bitwise
equal to their kernel path: both reduce with one accumulation.

On a CUDA tensor the wrapper launches ``csrc/ell_spmv.cu`` (built at
first use, see ``_build``) or raises; on a CPU tensor it runs
``ell_spmv_plain``, an eager slot loop with the kernel's arithmetic:
slots in order, each product rounded in the input dtype and widened to
float32, a float32 accumulator, the weight gated by the row mask first.
Out-of-range neighbour ids read the nearest row in both, as XLA's
gather clamps in the reference.
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
        lib = _build.load("ell_spmv")
        p = ctypes.c_void_p
        lib.ell_spmv_launch.argtypes = [p, p, p, p, p, ctypes.c_int64,
                                        ctypes.c_int32, ctypes.c_int64,
                                        ctypes.c_int32, ctypes.c_int32, p]
        lib.ell_spmv_launch.restype = ctypes.c_int
        lib.ell_spmv_error_string.argtypes = [ctypes.c_int]
        lib.ell_spmv_error_string.restype = ctypes.c_char_p
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


def ell_spmv(nbrs: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
             row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """y[v] = row_mask[v] * sum_j w[v, j] * x[nbrs[v, j]].

    nbrs:     [Nv, W] int32 (padded slots may point anywhere; w must be 0)
    w:        [Nv, W] float32 or bfloat16
    x:        [R, F]  same dtype as w (gather source)
    row_mask: [Nv] bool/float or None — rows with a falsy mask yield 0
    returns y: [Nv, F] in x's dtype

    ``ell_spmv.launches`` counts the CUDA kernel's launches.
    """
    tensors = [nbrs, w, x] + ([] if row_mask is None else [row_mask])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = x.device
    if device.type == "cpu":
        return ell_spmv_plain(nbrs, w, x, row_mask)
    if device.type != "cuda":
        raise ValueError(f"ell_spmv runs on cuda or cpu, not {device}")
    _check_cuda_args(nbrs, w, x, row_mask)
    nv, width = nbrs.shape
    y = torch.empty((nv, x.shape[1]), dtype=x.dtype, device=device)
    if y.numel() == 0:
        return y
    rm = None if row_mask is None else row_mask.to(w.dtype).contiguous()
    lib = _kernel_lib()
    with torch.cuda.device(device):
        err = lib.ell_spmv_launch(
            nbrs.data_ptr(), w.data_ptr(),
            None if rm is None else rm.data_ptr(), x.data_ptr(),
            y.data_ptr(), nv, width, x.shape[0], x.shape[1],
            _DTYPE_CODE[x.dtype], torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"ell_spmv launch failed: "
                           f"{lib.ell_spmv_error_string(err).decode()}")
    ell_spmv.launches += 1
    return y


ell_spmv.launches = 0


def ell_spmv_bucketed(nbrs_blocks, w_blocks, x: torch.Tensor,
                      row_masks=None) -> torch.Tensor:
    """Sliced-ELL SpMV: one width-specialized launch per degree bucket.

    Returns ``y [sum_b Nv_b, F]`` in bucketed row order (concatenated
    blocks); callers translate through the ``SlicedEll`` permutation.
    """
    ys = []
    for b, (nb, w) in enumerate(zip(nbrs_blocks, w_blocks)):
        rm = None if row_masks is None else row_masks[b]
        if nb.shape[0] == 0:
            ys.append(x.new_zeros((0, x.shape[1])))
            continue
        ys.append(ell_spmv(nb, w, x, row_mask=rm))
    return torch.cat(ys, dim=0)


def ell_spmv_batched(nbrs: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                     row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Window-shaped SpMV: one ``[B, W]`` launch over a gathered scope.
    Delegates to the shared launch, so a dense fold of the same window
    through ``ell_fold`` stays bitwise equal to it."""
    return ell_spmv(nbrs, w, x, row_mask=row_mask)


def ell_fold(w: torch.Tensor, vals: torch.Tensor,
             row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """y[b] = sum_j w[b, j] * vals[b, j]: the kernel's reduction applied
    to already-materialized scope values ``vals [B, D, F]``, through the
    identity gather ``idx[b, j] = b*D + j``."""
    b, d, f = vals.shape
    idx = (torch.arange(b, dtype=torch.int32, device=vals.device)[:, None] * d
           + torch.arange(d, dtype=torch.int32, device=vals.device)[None, :])
    return ell_spmv(idx, w, vals.reshape(b * d, f), row_mask=row_mask)
