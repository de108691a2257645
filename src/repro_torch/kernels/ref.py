"""Plain PyTorch oracles for the port's kernels (the correctness contract)."""
from __future__ import annotations

import torch


def ell_spmv_ref(nbrs: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                 row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """y[v] = row_mask[v] * sum_j w[v,j] * x[nbrs[v,j]]."""
    gathered = x[nbrs.long()]                 # [Nv, D, F]
    y = (w[..., None] * gathered).sum(dim=1)
    if row_mask is not None:
        y = y * row_mask.to(y.dtype)[:, None]
    return y


def als_normal_eq_ref(nbrs: torch.Tensor, mask: torch.Tensor,
                      ratings: torch.Tensor, x: torch.Tensor):
    """A[v] = sum_j m X_j X_j^T, b[v] = sum_j m r X_j, X_j = x[nbrs[v,j]]."""
    xg = x[nbrs.long()]                       # [Nv, D, d]
    xm = xg * mask.to(x.dtype)[..., None]
    a = torch.einsum("vdi,vdj->vij", xm, xg)
    b = torch.einsum("vdi,vd->vi", xm, ratings)
    return a, b
