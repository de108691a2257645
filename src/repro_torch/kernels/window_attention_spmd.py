"""B4 over a row-sharded KV cache: the decode attention of a DTensor
cache, and its ring insert.

The sharding rules put a cache's rows W over ``"model"`` from 4,096 rows
up, and over every axis at batch 1 (``launch.sharding.serve_state_specs``);
the reference also hints the decode scores' window axis onto
``"model"`` (``shardctx.hint(s, DP, None, None, TP)``), so XLA splits
even a cache held whole over ``"model"`` by rows.  Here each rank runs
B4's partial entry (``window_attention_partial``) on its own rows -- the
rows its shard holds, cut again by its ``"model"`` coordinate where the
cache is held whole over ``"model"`` (a view, nothing moved) -- with its
own lengths ``clamp(kv_len - offset, 0, rows)``, and the ranks merge
their partials (``merge_partials``): an all-reduce max of m, then
all-reduce sums of ``l e^(m - M)`` and ``o e^(m - M)``.  A rank with no
valid row gives ``m = -inf, l = 0`` and weighs 0 in the merge.  Where
no mesh dimension of more than one rank splits the rows (a one-rank
mesh), B4 runs whole on the local cache, as on one device.

Both run on the local shards through DTensor's ``local_map`` (the
attention) or on ``to_local`` views (the in-place insert): DTensor has
no rule for a hand-written kernel, nor for an in-place row write into a
sharded dimension, whose fallback would gather the whole cache.  The
query and the new K/V row are made whole over the non-batch axes first
(an all-gather of ``[B, H, dh]``, counted by the op walker); the output
``[B, H, dh]`` is sharded over the batch axes and whole over the rest.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.window_attention import (window_attention,
                                                  window_attention_partial)
from repro_torch.launch.local_rules import block_offset


def _stacked(t: torch.Tensor, op: str) -> torch.Tensor:
    return (t.amax if op == "max" else t.sum)(0, keepdim=True)


def merge_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                   reduce=None) -> torch.Tensor:
    """The attention ``O / L`` from partials ``(o [.., dh], m, l)``: ``M =
    max m``, ``L = sum l e^(m - M)``, ``O = sum o e^(m - M)``, a partial
    with ``m = -inf`` weighing 0.  ``reduce(t, op)`` (``op`` "max" or
    "sum") reduces over the ranks and keeps ``t``'s shape; by default the
    partials are stacked on a leading dimension of shards, which the
    result drops."""
    stacked = reduce is None
    reduce = reduce or _stacked
    big = reduce(m, "max")
    w = torch.where(torch.isinf(m), 0.0,
                    torch.exp(m - torch.where(torch.isinf(big), 0.0, big)))
    lsum = reduce(l * w, "sum")
    osum = reduce(o * w[..., None], "sum")
    out = osum / lsum[..., None]
    return out[0] if stacked else out


def _layout(cache):
    """``(batch_dims, row_dims, extra)``: the mesh dimensions that shard
    the cache's batch and its rows, and the ``"model"`` dimension to cut
    the local rows by (None where it shards the cache already, or does
    not divide its rows)."""
    tm = cache.device_mesh
    batch, rows = [], []
    for d, p in enumerate(cache.placements):
        if p.is_shard(0):
            batch.append(d)
        elif p.is_shard(1):
            rows.append(d)
        elif p.is_shard() or p.is_partial():
            raise ValueError(f"a KV cache is sharded over its batch and "
                             f"its rows only, not {cache.placements}")
    names = tuple(tm.mesh_dim_names or ())
    extra = names.index("model") if "model" in names else None
    local_rows = cache._local_tensor.shape[1]
    if extra is not None and (extra in batch or extra in rows
                              or local_rows % tm.size(extra)):
        extra = None
    return batch, rows, extra


def _placements(tm, batch_dims):
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if d in batch_dims else Replicate()
                 for d in range(tm.ndim))


def sharded_window_attention(q, k, v, kv_len):
    """B4 on DTensors: q ``[B, H, dh]``, k/v ``[B, W, Hkv, dh]`` sharded
    over the batch and the rows, kv_len ``[B]`` int32 (a DTensor or a
    plain tensor, whole).  Returns float32 ``[B, H, dh]``, sharded over
    the cache's batch axes."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map
    tm = k.device_mesh
    batch, rows, extra = _layout(k)
    # a mesh dimension of one rank splits nothing
    split = [d for d in rows + ([extra] if extra is not None else [])
             if tm.size(d) > 1]
    pl = _placements(tm, batch)
    if not isinstance(kv_len, DTensor):
        kv_len = DTensor.from_local(kv_len, tm, _placements(tm, ()),
                                    run_check=False)

    def reduce(t, op):
        for d in split:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (tm, d)))
        return t

    def local(ql, kl, vl, lens):
        if not split:
            return window_attention(ql, kl, vl, lens)
        n = kl.shape[1]
        off = block_offset(tm, rows, n)
        if extra is not None:
            n //= tm.size(extra)
            cut = tm.get_coordinate()[extra] * n
            kl, vl = kl[:, cut:cut + n], vl[:, cut:cut + n]
            off += cut
        mine = torch.clamp(lens - off, 0, n).to(torch.int32)
        o, m, l = window_attention_partial(ql, kl, vl, mine)
        return merge_partials(o, m, l, reduce)

    return local_map(local, out_placements=(pl,),
                     in_placements=(pl, k.placements, v.placements, pl),
                     device_mesh=tm, redistribute_inputs=True)(
        q, k, v, kv_len)


def sharded_ring_insert(cache, new, slot) -> None:
    """In place: row ``slot[b]`` of request b of a DTensor cache ``[B, W,
    H, dh]`` gets ``new[b, 0]`` (``[B, 1, H, dh]``).  Each rank writes
    the slots that lie in its rows and rewrites the row it holds
    otherwise (no host read decides which)."""
    from torch.distributed.tensor import DTensor
    tm = cache.device_mesh
    batch, rows, _ = _layout(cache)
    pl = _placements(tm, batch)
    if not isinstance(slot, DTensor):
        slot = DTensor.from_local(slot, tm, _placements(tm, ()),
                                  run_check=False)
    new = new.redistribute(tm, pl).to_local()
    slot = slot.redistribute(tm, pl).to_local()
    cl = cache.to_local()
    n = cl.shape[1]
    local = slot - block_offset(tm, rows, n)
    inside = (local >= 0) & (local < n)
    at = torch.clamp(local, 0, n - 1)
    ar = torch.arange(cl.shape[0], device=cl.device)
    row = new[:, 0].to(cl.dtype)
    cl[ar, at] = torch.where(inside[:, None, None], row, cl[ar, at])
