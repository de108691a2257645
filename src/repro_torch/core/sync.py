"""The sync operation (paper §3.3): (Key, Fold, Merge, Finalize, acc0, tau).

The port of ``repro.core.sync``.  Fold and Merge are written for one
row and one pair of accumulators, exactly as in the reference, and are
batched with ``torch.func.vmap``.  The reduction is the reference's
**pairwise halving tree**: each level merges the first half of the
contributions with the second half elementwise, carrying an odd tail.
Its order of operations depends only on the row count, so a sum comes
out bitwise the same on the CPU and on the GPU (``torch.sum`` makes no
such promise).  ``valid`` masks rows out (their contributions become
``acc0``) before the tree, and ``sequential=True`` folds the rows one at
a time in order instead, the reference's ``lax.scan``: a Python loop
over rows, meant for tests and small graphs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.func import vmap

PyTree = Any


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of matching tuples / lists / dicts."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class SyncOp:
    key: str
    fold: Callable[[PyTree, PyTree], PyTree]      # (acc, v_data_row) -> acc
    merge: Callable[[PyTree, PyTree], PyTree]     # (acc, acc') -> acc
    finalize: Callable[[PyTree], PyTree]          # acc -> result
    acc0: PyTree
    tau: int = 1            # run every `tau` supersteps
    sequential: bool = False

    def local_reduce(self, vertex_data: dict,
                     valid: torch.Tensor | None = None) -> PyTree:
        """Fold+Merge over the local vertex set -> partial accumulator.

        Parallel: fold every vertex against ``acc0``, replace the rows
        ``valid`` masks out by ``acc0``, then Merge the contributions
        down the pairwise halving tree.  ``sequential``: fold the rows
        one at a time in order, a masked row leaving the accumulator as
        it was."""
        device = _leaves(vertex_data)[0].device
        acc0 = tree_map(lambda a: torch.as_tensor(a).to(device), self.acc0)
        n = _leaves(vertex_data)[0].shape[0]
        if self.sequential:
            ok = None if valid is None else valid.cpu().tolist()
            acc = acc0
            for i in range(n):
                if ok is None or ok[i]:
                    acc = self.fold(acc, tree_map(lambda x: x[i],
                                                  vertex_data))
            return acc
        c = vmap(lambda row: self.fold(acc0, row))(vertex_data)
        if valid is not None:
            valid = valid.to(device)
            c = tree_map(
                lambda x, z: torch.where(
                    valid.reshape((-1,) + (1,) * (x.dim() - 1)), x,
                    z.to(x.dtype)), c, acc0)
        merge = vmap(self.merge)
        m = _leaves(c)[0].shape[0]
        while m > 1:
            half = m // 2
            merged = merge(tree_map(lambda x: x[:half], c),
                           tree_map(lambda x: x[half:2 * half], c))
            if m % 2:
                merged = tree_map(lambda x, t: torch.cat([x, t[m - 1:m]]),
                                  merged, c)
            c = merged
            m = half + m % 2
        return tree_map(lambda x: x[0], c)

    def run(self, vertex_data: dict,
            valid: torch.Tensor | None = None) -> PyTree:
        return self.finalize(self.local_reduce(vertex_data, valid))


def sum_sync(key: str, value_fn: Callable[[PyTree], torch.Tensor],
             tau: int = 1, finalize: Callable | None = None,
             init=0.0) -> SyncOp:
    """Convenience constructor for the ubiquitous additive sync."""
    return SyncOp(
        key=key,
        fold=lambda acc, row: acc + value_fn(row),
        merge=lambda a, b: a + b,
        finalize=finalize or (lambda a: a),
        acc0=torch.tensor(init, dtype=torch.float32),
        tau=tau,
    )


def _top2(vals: torch.Tensor, ids: torch.Tensor):
    # a stable descending sort puts the lower index first on ties, as
    # lax.top_k does; torch.topk promises no tie order
    order = torch.sort(vals, descending=True, stable=True).indices[:2]
    return vals[order], ids[order]


def top_two_sync(key: str, rank_fn: Callable[[PyTree], torch.Tensor],
                 id_fn=None, tau: int = 1) -> SyncOp:
    """The paper's running example: second most popular page (§3.3).

    acc = (top2 values, top2 ids); Finalize extracts entry [1].
    """
    def fold(acc, row):
        vals, ids = acc
        r = rank_fn(row).to(torch.float32)
        i = (id_fn(row).to(torch.int32) if id_fn is not None
             else ids.new_full((), -1))
        return _top2(torch.cat([vals, r[None]]), torch.cat([ids, i[None]]))

    def merge(a, b):
        return _top2(torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]]))

    return SyncOp(
        key=key, fold=fold, merge=merge,
        finalize=lambda acc: (acc[0][1], acc[1][1]),
        acc0=(torch.full((2,), -torch.inf),
              torch.full((2,), -1, dtype=torch.int32)),
        tau=tau,
    )
