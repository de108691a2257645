"""Hand-written "MPI-style" distributed ALS (paper §6.2 comparison), on
the port.

The port of ``repro.baselines.mpi_als``.  The paper compares GraphLab
with a from-scratch MPI implementation built on synchronous
collectives: the user and movie factor blocks are sharded over devices,
and each half-iteration ``all_gather``s the *entire* opposing factor
matrix (the classic dense-replication MPI ALS).  No framework, no data
graph, no ghosts, no adaptivity: the yardstick for "does the
abstraction cost anything?".

The gather goes through a ``repro_torch.core.mesh`` mesh (a
``LocalMesh`` by default, or a ``ProcessGroupMesh``: one shard a rank).
Each shard's rating lists are degree-bucketed sliced rows (the
reference's dense ``[rows, D_max]`` ELL would be tens of GB at
Netflix's width), and the normal equations ``A = X^T X``, ``b = X^T r``
go through the ``als_normal_eq`` CUDA kernel (B3), the same function as
the reference's two einsums; the ridge and the LU solve stay PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.als import ALSProblem, _full_f32_matmul
from repro_torch.core.graph import (default_bucket_widths,
                                    sliced_ell_from_slots)
from repro_torch.core.mesh import LocalMesh
from repro_torch.kernels.als_normal_eq import als_normal_eq_bucketed


class _SideBlock:
    """One shard's destination rows of one side: their rating lists as
    sliced rows (neighbour = the source row, edge id = the rating's
    index), on the shard's device."""

    def __init__(self, side, ratings, row0: int, n_rows: int, device):
        counts, ptr, flat, widths = side
        cnt = counts[row0: row0 + n_rows]
        ne = len(ratings)
        ell = sliced_ell_from_slots(ptr[row0: row0 + n_rows], cnt, flat,
                                    pad_edge=ne, widths=widths,
                                    max_deg=widths[-1], device=device)
        r_ext = torch.from_numpy(np.append(ratings, np.float32(0.0)).astype(
            np.float32)).to(device)
        self.nbrs, self.mask = ell.nbrs, ell.nbr_mask
        self.ratings = tuple(r_ext[e.long()] for e in ell.edge_ids)
        self.inv_perm = ell.inv_perm.long()
        self.n_obs = torch.from_numpy(cnt.astype(np.float32)).to(device)


def _side(dst, src, n_pad: int):
    """One side's rating lists: each destination row's ratings in rating
    order, as ``(counts [n_pad], first slot [n_pad], (src, rating index,
    unused), bucket widths)``."""
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=n_pad)
    ptr = np.concatenate([[0], np.cumsum(counts)[:-1]])
    flat = (src[order].astype(np.int32), order.astype(np.int32),
            np.zeros(len(order), bool))
    return counts, ptr, flat, default_bucket_widths(
        max(1, int(counts.max(initial=1))))


def _solve(block: _SideBlock, w_other_full, w_old, d: int, lam: float):
    """Ridge-regularized least squares of every row of ``block`` given
    the gathered opposing factors; rows without ratings keep theirs."""
    a, b = als_normal_eq_bucketed(block.nbrs, block.mask, block.ratings,
                                  w_other_full.contiguous())
    a, b = a[block.inv_perm], b[block.inv_perm]
    a = a + (lam * block.n_obs.clamp_min(1.0))[:, None, None] * torch.eye(
        d, dtype=a.dtype, device=a.device)
    with _full_f32_matmul():
        w_new = torch.linalg.solve_ex(a, b[..., None]).result[..., 0]
    return torch.where(block.n_obs[:, None] > 0, w_new, w_old)


def _default_mesh(n_devices: int | None, device: torch.device):
    """The reference runs on every local device: every GPU of the
    problem's device type, one shard each (one shard on the CPU)."""
    if n_devices is not None:
        return LocalMesh(n_devices, [device])
    if device.type != "cuda":
        return LocalMesh(1, [device])
    n = torch.cuda.device_count()
    return LocalMesh(n, [torch.device("cuda", i) for i in range(n)])


class MPIBlocks:
    """The set-up of MPI-style ALS: each local shard's rating lists of
    its user and movie rows, and its factor blocks (``wu``, ``wv``)."""

    def __init__(self, problem: ALSProblem, mesh):
        w = problem.graph.vertex_data["w"]
        self.mesh, self.d = mesh, problem.d
        m = mesh.n_shards
        self.n_users, self.n_movies = problem.n_users, problem.n_movies
        bu, bv = -(-self.n_users // m), -(-self.n_movies // m)
        self.nu_pad, self.nv_pad = bu * m, bv * m
        pairs = np.asarray(problem.pairs, np.int64)
        ratings = np.asarray(problem.ratings, np.float32)
        to_users = _side(pairs[:, 0], pairs[:, 1], self.nu_pad)
        to_movies = _side(pairs[:, 1], pairs[:, 0], self.nv_pad)

        def pad_rows(x, n):
            out = x.new_zeros((n,) + tuple(x.shape[1:]))
            out[: x.shape[0]] = x
            return out

        wu_all = pad_rows(w[: self.n_users], self.nu_pad)
        wv_all = pad_rows(w[self.n_users:], self.nv_pad)
        self.users, self.movies, self.wu, self.wv = [], [], [], []
        for i in mesh.shards:
            dev = mesh.device(i)
            self.users.append(_SideBlock(to_users, ratings, i * bu, bu, dev))
            self.movies.append(_SideBlock(to_movies, ratings, i * bv, bv,
                                          dev))
            self.wu.append(wu_all[i * bu: (i + 1) * bu].to(dev))
            self.wv.append(wv_all[i * bv: (i + 1) * bv].to(dev))

    @property
    def bytes_per_iter(self) -> int:
        """The all-gather volume of one iteration."""
        return (self.nu_pad + self.nv_pad) * self.d * 4 * (
            self.mesh.n_shards - 1)

    def gather(self, blocks, n):
        return [g.reshape(n, self.d)
                for g in self.mesh.all_gather(blocks)]

    def iterate(self, lam: float) -> None:
        """One iteration: movies given the all-gathered user factors
        (MPI style), then users given the all-gathered movie factors."""
        wu_full = self.gather(self.wu, self.nu_pad)
        self.wv = [_solve(blk, full, old, self.d, lam)
                   for blk, full, old in zip(self.movies, wu_full, self.wv)]
        wv_full = self.gather(self.wv, self.nv_pad)
        self.wu = [_solve(blk, full, old, self.d, lam)
                   for blk, full, old in zip(self.users, wv_full, self.wu)]

    def factors(self):
        """``(w_users, w_movies)``, gathered from every shard."""
        return (self.gather(self.wu, self.nu_pad)[0][: self.n_users],
                self.gather(self.wv, self.nv_pad)[0][: self.n_movies])


def als_mpi(problem: ALSProblem, n_iters: int, n_devices: int | None = None,
            lam: float = 0.02, mesh=None):
    """Returns ``(w_users, w_movies, info)`` after ``n_iters`` iterations
    (movies given users, then users given movies), the factors as
    tensors; ``info["bytes_per_iter"]`` is the all-gather volume.

    ``mesh`` shards the factor blocks (default: a ``LocalMesh`` of
    ``n_devices`` shards on the problem graph's device, or one shard per
    local GPU)."""
    if mesh is None:
        mesh = _default_mesh(n_devices, problem.graph.vertex_data["w"].device)
    blocks = MPIBlocks(problem, mesh)
    for _ in range(n_iters):
        blocks.iterate(lam)
    wu, wv = blocks.factors()
    return wu, wv, {"bytes_per_iter": blocks.bytes_per_iter}
