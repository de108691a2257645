"""Hand-written sharding rules: the sites of the model code where
DTensor has no sharding strategy for an op, or has one that is wrong or
would gather a large tensor, run on the local shards instead
(``torch.distributed.tensor.experimental.local_map``).  Each says which
collective it adds; ``PERF.md`` lists them.  Nothing here runs on a
plain tensor: the callers take their one-device path then.
"""
from __future__ import annotations

import torch


def _shard_dims(x, dim: int) -> list:
    """The mesh dimensions on which DTensor ``x`` is ``Shard(dim)``."""
    return [d for d, p in enumerate(x.placements) if p.is_shard(dim)]


def block_offset(tm, dims, n: int) -> int:
    """This rank's first index of a dimension split over the mesh
    dimensions ``dims`` (in mesh order, the first the slowest) into
    blocks of ``n``."""
    coord = tm.get_coordinate()
    index = 0
    for d in dims:
        index = index * tm.size(d) + coord[d]
    return index * n


def label_logits(logits, labels):
    """``logits[b, s, labels[b, s]]`` of DTensor logits ``[B, S, V]``
    sharded over V: each rank gathers the labels its vocabulary block
    holds and zeros the rest, and the result is ``Partial`` over the
    vocabulary's axes (one all-reduce of ``[B, S]`` float32 where it is
    used).  DTensor's own rule for this gather (a masked partial) fails
    on the gathered column's removal."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    tm = logits.device_mesh
    vocab = _shard_dims(logits, 2)
    batch = _shard_dims(logits, 0)
    in_lab = tuple(Shard(0) if d in batch else Replicate()
                   for d in range(tm.ndim))
    out = tuple(Partial() if d in vocab else p for d, p in enumerate(in_lab))

    def local(lg, lab):
        n = lg.shape[-1]
        idx = lab.long() - block_offset(tm, vocab, n)
        inside = (idx >= 0) & (idx < n)
        got = torch.gather(lg, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(inside, got, 0.0)

    return local_map(local, out_placements=(out,),
                     in_placements=(logits.placements, in_lab),
                     device_mesh=tm, redistribute_inputs=True)(logits, labels)


def vocab_embedding(table, tokens):
    """``table[tokens]`` of a DTensor embedding ``[V, d]`` sharded over V
    (and over d by FSDP): the table's FSDP-sharded d gathered (a weight's
    all-gather over the data axes), each rank looks up the tokens its
    vocabulary block holds and zeros the rest, and the result ``[B, S,
    d]`` is ``Partial`` over the vocabulary's axes (the caller lays it
    out, a reduce-scatter).  DTensor's own lookup moves the table and
    then the activations between layouts."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch import sharding, shardctx
    tm = table.device_mesh
    vocab = _shard_dims(table, 0)
    t_pl = tuple(Shard(0) if d in vocab else Replicate()
                 for d in range(tm.ndim))
    tok_pl = sharding.placements((shardctx.DP,), tm, (tokens.shape[0],))
    out = tuple(Partial() if d in vocab else p for d, p in enumerate(tok_pl))

    def local(tl, tok):
        n = tl.shape[0]
        idx = tok.long() - block_offset(tm, vocab, n)
        inside = (idx >= 0) & (idx < n)
        rows = tl[idx.clamp(0, n - 1)]
        return torch.where(inside[..., None], rows, 0)

    return local_map(local, out_placements=(out,),
                     in_placements=(t_pl, tok_pl), device_mesh=tm,
                     redistribute_inputs=True)(table, tokens)


def vocab_logsumexp(logits):
    """``logsumexp`` over the last dimension of DTensor logits sharded
    over it, in DTensor's own ops: a max and a sum over the sharded
    dimension (an all-reduce of ``[B, S]`` each) around the local
    exponentials.  DTensor's ``logsumexp`` gathers the ``[B, S, V]``
    logits first.  The max is detached: it shifts the exponentials and
    cancels from the value and its gradient."""
    big = logits.detach().amax(dim=-1, keepdim=True)
    return (big + torch.log(torch.exp(logits - big).sum(dim=-1,
                                                          keepdim=True)))[
        ..., 0]


def expert_counts(eidx, n_experts: int):
    """How many of the assignments ``eidx`` (a DTensor of expert ids) go
    to each expert, float32 ``[E]``: each rank counts its own block by a
    scatter-add, and the result is ``Partial`` over the axes that shard
    ``eidx`` (an all-reduce of ``[E]`` where it is used).  DTensor has no
    rule for a scatter-add into a replicated buffer at sharded indices."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    tm = eidx.device_mesh
    out = tuple(Partial() if p.is_shard() else Replicate()
                for p in eidx.placements)

    def local(e):
        flat = e.reshape(-1)
        return torch.zeros(n_experts, dtype=torch.float32,
                           device=e.device).index_add_(
            0, flat, torch.ones(flat.shape, device=e.device))

    return local_map(local, out_placements=(out,),
                     in_placements=(eidx.placements,),
                     device_mesh=tm)(eidx)


def by_group(fn, spec_dims: tuple, *args):
    """``fn`` run on each rank's groups: every argument is laid out with
    its leading (group) dimension over the data axes that divide it and
    the rest whole (an all-gather of what another axis shards), and
    every output comes back so.  For the MoE's sort-based dispatch, whose
    sort, ``searchsorted`` and scatter into the capacity buffer are each
    within one group and have no DTensor rule.  ``spec_dims``: the
    number of outputs."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch import sharding, shardctx
    x = args[0]
    tm = x.device_mesh
    pl = sharding.placements((shardctx.DP,), tm, (x.shape[0],))
    return local_map(fn, out_placements=(pl,) * spec_dims,
                     in_placements=(pl,) * len(args), device_mesh=tm,
                     redistribute_inputs=True)(*args)


def by_expert(fn, buf, *weights):
    """``fn(buf, *weights)`` -- the expert FFN over ``buf [G, E, cap, d]``
    laid out as the reference's hint puts it (groups over the data axes,
    experts over ``"model"``) -- run on each rank's experts with the
    weights ``[E, ., .]`` whole but for the experts (an all-gather of
    their FSDP-sharded dimension over the data axes, the reference's
    FSDP gather).  DTensor's einsum decomposes into views that a local
    block of the expert-sharded buffer does not take."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    tm = buf.device_mesh
    experts = _shard_dims(buf, 1)
    w_pl = tuple(Shard(0) if d in experts else Replicate()
                 for d in range(tm.ndim))
    return local_map(fn, out_placements=(buf.placements,),
                     in_placements=(buf.placements,) + (w_pl,) * len(weights),
                     device_mesh=tm, redistribute_inputs=True)(buf, *weights)


def by_heads(fn, q, k, v, n_rep: int):
    """``fn(q, k, v, n_rep, q_start)`` -- an attention over ``q [B, S, H,
    dh]`` (at positions ``q_start`` on) and ``k``/``v [B, T, Hkv, dh]``
    -- run on each rank's requests and query heads: q laid out as
    ``shardctx.heads_spec`` puts it, k and v over the same batch axes
    and over the same head axes where they divide Hkv, else whole (each
    rank then takes the KV heads of its query heads, repeated, and runs
    ``fn`` with ``n_rep = 1``).  Where ``"model"`` divides no head count
    but does S, the queries go over it instead (each rank a block of
    positions against the whole K/V, which is gathered), so no rank
    computes another's heads.  The flash attention's loop of chunk
    slices, stacks and einsums has no layout DTensor keeps local; these
    are local by construction."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch import shardctx
    tm = q.device_mesh
    b, s, h, dh = q.shape
    q_pl = shardctx.heads_spec((b, s, h * dh), h, tm)
    heads = [d for d, p in enumerate(q_pl) if p.is_shard(2)]
    names = tuple(tm.mesh_dim_names or ())
    rows = []
    if not heads and "model" in names:
        m = names.index("model")
        if not q_pl[m].is_shard() and s % tm.size(m) == 0:
            rows = [m]
            q_pl = tuple(Shard(1) if d == m else p
                         for d, p in enumerate(q_pl))
    split = 1
    for d in heads:
        split *= tm.size(d)
    kv_sharded = k.shape[2] % split == 0
    kv_pl = tuple(p if p.is_shard(0) or (kv_sharded and p.is_shard(2))
                  else Replicate() for p in q_pl)

    def local(ql, kl, vl):
        q0 = block_offset(tm, rows, ql.shape[1])
        if kv_sharded:
            return fn(ql, kl, vl, n_rep, q0)
        hl = ql.shape[2]
        h0 = block_offset(tm, heads, hl)
        lo, hi = h0 // n_rep, (h0 + hl - 1) // n_rep + 1
        cut = h0 - lo * n_rep

        def pick(t):
            return t[:, :, lo:hi].repeat_interleave(n_rep, dim=2)[
                :, :, cut:cut + hl]
        return fn(ql, pick(kl), pick(vl), 1, q0)

    return local_map(local, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl), device_mesh=tm,
                     redistribute_inputs=True)(q, k, v)


def by_channels(fn, a, dt, xf, bmat, cmat):
    """``fn(a, dt, xf, bmat, cmat)`` -- the Mamba scan, independent per
    (request, channel) -- run on each rank's requests and channels:
    ``dt``, ``xf`` ``[B, S, di]`` laid out as the residual stream (the
    batch over the data axes, the channels over ``"model"``), ``a [di,
    ds]`` with the same channels, ``bmat``, ``cmat`` ``[B, S, ds]`` over
    the batch and whole (an all-reduce where ``x_proj``'s product left
    them partial); the output ``[B, S, di]`` as ``xf``.  DTensor's rules
    for the scan's chunk slices, cats and einsum gather every chunk's
    ``[B, c, di]`` over the data axes instead."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch import sharding, shardctx
    tm = xf.device_mesh
    pl = sharding.placements((shardctx.DP, None, shardctx.TP), tm,
                             tuple(xf.shape))
    channels = tuple(Shard(0) if p.is_shard(2) else Replicate() for p in pl)
    whole = tuple(p if p.is_shard(0) else Replicate() for p in pl)
    return local_map(fn, out_placements=(pl,),
                     in_placements=(channels, pl, pl, whole, whole),
                     device_mesh=tm, redistribute_inputs=True)(
        a, dt, xf, bmat, cmat)
