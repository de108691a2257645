"""The GraphLab data graph (paper §3.1) as PyTorch tensors.

The port of ``repro.core.graph``.  The adjacency is the same
**degree-bucketed sliced ELL**: vertices are permuted into width buckets
(2, 4, ..., ``max_deg``), each bucket stores its own padded
``[Nv_b, W_b]`` block, and the aggregation kernel takes every bucket
at its own width, all in one launch.  The builder is the reference's, step for
step, so every block, permutation and edge renumbering is bitwise the
reference's (``tests/test_torch_graph.py``).

Conventions (per bucket block, and in any padded view of it):

* ``nbrs[v, j]``      -- vertex id of the j-th neighbor of v (0 if padded)
* ``nbr_mask[v, j]``  -- True for real neighbor slots
* ``edge_ids[v, j]``  -- edge id of that slot; padded slots hold the pad
                         edge row ``n_edges``
* ``is_src[v, j]``    -- True iff v is endpoint 0 of that edge

Vertex and edge data are dicts of tensors with leading dim ``Nv`` resp.
``n_edges + 1`` (one pad row).  Hub splitting (``hub_split=`` /
``w_cap=``) chunks rows wider than ``w_cap`` into virtual rows, as the
reference does.  Mutation slack and measured width plans are not ported
yet (ROADMAP A11, A8): asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


class EllRows(NamedTuple):
    """A batch of adjacency rows materialized at width ``[B, D]``."""
    nbrs: torch.Tensor
    nbr_mask: torch.Tensor
    edge_ids: torch.Tensor
    is_src: torch.Tensor


# the largest batch (rows x width) gathered by ``_flat_rows``; larger
# ones take ``_bucket_rows``.  Below it the per-bucket gather's host
# syncs cost more than the flat gather's extra bytes.  On an H100 the two
# cross near 1.5e8 slots at width 256 (the row-gather lines of
# ``chip_smoke.py``'s phase 11: flat 1.5 against 2.8 ms at 262,144 x
# 256, 6.6 against 3.7 ms at 1,260,973 x 256)
FLAT_GATHER_SLOTS = 1 << 27

# each block of the flat stores starts on a multiple of this many slots
# (256 bytes of int32), as a block allocated on its own would: the
# kernels' vector loads need an aligned row base
SLOT_ALIGN = 64


def sliced_slot_count(starts: Sequence[int], widths: Sequence[int]) -> int:
    """Stored (= bucket-kernel-computed) slots ``sum_b Nv_b * W_b``."""
    return sum((starts[b + 1] - starts[b]) * widths[b]
               for b in range(len(widths)))


def _tensor_dict(data, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            if not isinstance(v, torch.Tensor) else v.to(device)
            for k, v in (data or {}).items()}


# ----------------------------------------------------------------------
# Sliced ELL: degree-bucketed adjacency storage
# ----------------------------------------------------------------------

@dataclasses.dataclass
class SlicedEll:
    """Degree-bucketed adjacency: one padded block per width bucket.

    Bucket ``b`` holds the contiguous position range
    ``[starts[b], starts[b+1])`` with block width ``widths[b]``.
    ``perm[p]`` is the row stored at bucketed position ``p``;
    ``inv_perm[r]`` is the position of row ``r``.  Neighbor values in
    the blocks are row ids in the original addressing.  The blocks are
    views of four flat stores (``slots``), so a batch of rows from any
    buckets is one gather of each.

    Hub splitting: with ``w_cap`` set, rows wider than ``w_cap`` are
    chunked into virtual rows of width ``<= w_cap``; the blocks,
    ``perm`` and ``inv_perm`` then live in virtual-row space while
    ``n_rows`` / ``max_deg`` keep describing owner rows.  Row ``r``'s
    virtual rows are the id range ``[vrow_offset[r], vrow_offset[r+1])``,
    chunk ``k`` holding its slots ``[k*w_cap, (k+1)*w_cap)``.
    """

    widths: tuple[int, ...]
    starts: tuple[int, ...]
    n_rows: int                           # owner rows when split
    max_deg: int                          # owner max degree when split
    pad_edge: int
    # the stored slots, flat: bucket b's block row-major from
    # ``block_offsets(...)[0][b]``; the gaps between blocks and the last
    # slot hold padding (nbr 0, unmasked, the pad edge, not src)
    slots: EllRows
    perm: torch.Tensor                    # [total_rows] int32
    inv_perm: torch.Tensor                # [n_rows] int32
    # views of ``slots``: bucket b's [Nv_b, W_b] blocks
    nbrs: tuple[torch.Tensor, ...] = dataclasses.field(
        init=False, repr=False, compare=False)          # int32
    nbr_mask: tuple[torch.Tensor, ...] = dataclasses.field(
        init=False, repr=False, compare=False)          # bool
    edge_ids: tuple[torch.Tensor, ...] = dataclasses.field(
        init=False, repr=False, compare=False)          # int32
    is_src: tuple[torch.Tensor, ...] = dataclasses.field(
        init=False, repr=False, compare=False)          # bool
    # hub splitting; None / 1 when unsplit
    w_cap: int | None = None              # chunk width cap (a power of 2)
    n_chunks_max: int = 1                 # most virtual rows of any owner
    owner_of_vrow: torch.Tensor | None = None   # [n_virtual] int32
    vrow_offset: torch.Tensor | None = None     # [n_rows + 1] int32

    def __post_init__(self):
        offs, pad = block_offsets(self.starts, self.widths)
        sizes = [e - s for s, e in zip(self.starts, self.starts[1:])]
        self.nbrs, self.nbr_mask, self.edge_ids, self.is_src = (
            tuple(flat[o: o + n * w].view(n, w)
                  for o, n, w in zip(offs, sizes, self.widths))
            for flat in self.slots)
        # per bucketed position (and the ``total_rows`` sentinel): the
        # row's width (0 for the sentinel) and its first slot in ``slots``
        b = np.repeat(np.arange(self.n_buckets), sizes)
        row = np.arange(self.total_rows) - np.asarray(self.starts[:-1])[b]
        width = np.asarray(self.widths, np.int64)[b]
        offset = np.asarray(offs, np.int64)[b] + row * width
        up = lambda a: torch.from_numpy(
            np.append(a, 0).astype(np.int32)).to(self.device)
        self._row_width, self._row_offset = up(width), up(offset)
        self._pad_slot = pad
        self._ends = torch.tensor(self.starts[1:], dtype=torch.int32,
                                  device=self.device)
        # window_bucket's chunk-count classes past the buckets: 2, 4, ...
        n_wide = len(self.scope_widths) - self.n_buckets
        self._chunk_bounds = torch.tensor([2 << j for j in range(n_wide)],
                                          dtype=torch.int32,
                                          device=self.device)

    @property
    def device(self) -> torch.device:
        return self.perm.device

    @property
    def n_buckets(self) -> int:
        return len(self.widths)

    @property
    def is_split(self) -> bool:
        return self.w_cap is not None

    @property
    def n_virtual(self) -> int:
        """Virtual rows (== addressable rows when unsplit)."""
        return (self.n_rows if self.owner_of_vrow is None
                else self.owner_of_vrow.shape[0])

    @property
    def scope_widths(self) -> tuple[int, ...]:
        """Width classes of batch-shaped gathers: the bucket widths and,
        when split, the chunk multiples ``2*w_cap, 4*w_cap, ...`` up to
        the first one covering ``max_deg`` (hub rows are gathered as
        several chunks)."""
        if self.w_cap is None:
            return self.widths
        ws = list(self.widths)
        w = self.w_cap * 2
        while w < self.max_deg:
            ws.append(w)
            w *= 2
        ws.append(w)
        return tuple(ws)

    @property
    def total_rows(self) -> int:
        return self.starts[-1]

    @property
    def padded_slots(self) -> int:
        """Stored (= kernel-computed) neighbor slots, padding included."""
        return sliced_slot_count(self.starts, self.widths)

    @property
    def bucket_launches(self) -> tuple[tuple[int, int], ...]:
        """The ``(width, rows)`` launch sequence of one bucket sweep."""
        return tuple(
            (int(self.widths[b]), int(self.starts[b + 1] - self.starts[b]))
            for b in range(self.n_buckets))

    def bucket_slices(self, arr: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Split a ``[total_rows, ...]`` tensor into per-bucket views."""
        return tuple(arr[self.starts[b]: self.starts[b + 1]]
                     for b in range(self.n_buckets))

    def snap_width(self, width: int) -> int:
        """Snap a requested scope width up to the nearest bucket width."""
        for w in self.scope_widths:
            if w >= width:
                return w
        return self.scope_widths[-1]

    def window_bucket(self, ids: torch.Tensor, sel: torch.Tensor) -> int:
        """Index (into ``scope_widths``) of the widest width class a
        selected row of the window needs; 0 for an empty selection.

        The batch-shaped dispatch branches on it on the host, so it is
        one device-to-host read (``.item()``) a call.  When split,
        single-chunk rows report their virtual row's bucket and hub rows
        the chunk-count class ``n_buckets + log2ceil(n_chunks) - 1``.
        """
        if ids.numel() == 0:
            return 0
        ids = ids.long()
        if self.w_cap is None:
            b = torch.searchsorted(self._ends, self.inv_perm[ids],
                                   right=True)
            return int(torch.where(sel, b, 0).max().item())
        off = self.vrow_offset
        nch = off[ids + 1] - off[ids]
        b_single = torch.searchsorted(
            self._ends, self.inv_perm[off[ids].long()], right=True)
        b_wide = self.n_buckets + torch.searchsorted(self._chunk_bounds, nch)
        cls = torch.where(nch > 1, b_wide, b_single)
        return int(torch.where(sel, cls, 0).max().item())

    def rows(self, ids: torch.Tensor, width: int | None = None) -> EllRows:
        """Materialize ``[B, W]`` adjacency rows (default ``W=max_deg``);
        columns past a row's bucket width read as padding.  ``width``
        snaps up to a scope width; rows of wider classes then read as
        empty, so callers pass at least the window's ``window_bucket``
        width.  When split, a row wider than ``w_cap`` is its chunks
        side by side (``s = W / w_cap`` of them, gathered at once), so
        the owner-space view is bitwise the unsplit padded row."""
        ids = ids.long()
        if self.w_cap is None:
            d = self.max_deg if width is None else self.snap_width(width)
            return self._gather_rows(self.inv_perm[ids], d)
        off = self.vrow_offset
        first = off[ids].long()
        nch = off[ids + 1].long() - first
        if width is not None:
            d = self.snap_width(width)
            if d <= self.w_cap:
                # single-chunk class: hubs (nch > 1) read as empty
                pos = torch.where(nch == 1, self.inv_perm[first],
                                  self.total_rows)
                return self._gather_rows(pos, d)
            s = d // self.w_cap
        else:
            s = -(-self.max_deg // self.w_cap)
        k = torch.arange(s, device=self.device)
        ok = (k < nch[:, None]) & (nch[:, None] <= s)
        vid = (first[:, None] + k).clamp_max(self.n_virtual - 1)
        pos = torch.where(ok, self.inv_perm[vid], self.total_rows)
        b = ids.shape[0]
        out = EllRows(*(a.view(b, s * self.w_cap) for a in
                        self._gather_rows(pos.view(-1), self.w_cap)))
        if width is None and s * self.w_cap != self.max_deg:
            out = EllRows(*(a[:, : self.max_deg] for a in out))
        return out

    def _gather_rows(self, pos: torch.Tensor, d: int) -> EllRows:
        """Rows at bucketed positions ``pos [B]``; positions outside
        every bucket (the ``total_rows`` sentinel) read as padding.
        Batches of at most ``FLAT_GATHER_SLOTS`` slots take
        ``_flat_rows``, larger ones ``_bucket_rows``: the same rows.
        """
        if pos.shape[0] * d <= FLAT_GATHER_SLOTS:
            return self._flat_rows(pos, d)
        return self._bucket_rows(pos, d)

    def _flat_rows(self, pos: torch.Tensor, d: int) -> EllRows:
        """The gather as one ``index_select`` of each flat store, with no
        host sync: slot ``j`` of the row at ``p`` is element
        ``_row_offset[p] + j`` where ``j`` is below the row's width (and
        the width at most ``d``: a wider row reads as empty), else the
        pad slot.  It reads and writes ~40 bytes a ``[B, d]`` slot."""
        width = self._row_width.index_select(0, pos)
        width = torch.where(width <= d, width, 0)
        cols = torch.arange(d, dtype=torch.int32, device=self.device)
        idx = self._row_offset.index_select(0, pos)[:, None] + cols
        idx.masked_fill_(cols >= width[:, None], self._pad_slot)
        idx = idx.view(-1)
        return EllRows(*(s.index_select(0, idx).view(pos.shape[0], d)
                         for s in self.slots))

    def _bucket_rows(self, pos: torch.Tensor, d: int) -> EllRows:
        """The gather bucket by bucket: outputs filled with padding at
        ``[B, d]``, then each bucket copies the leading ``W_b`` columns
        of its own rows from its block.  A bucket's rows are found with
        a ``nonzero``, one host sync a bucket, but only stored slots are
        copied (~10 bytes a ``[B, d]`` slot)."""
        b_rows = pos.shape[0]
        dev = self.device
        out_n = torch.zeros((b_rows, d), dtype=torch.int32, device=dev)
        out_m = torch.zeros((b_rows, d), dtype=torch.bool, device=dev)
        out_e = torch.full((b_rows, d), self.pad_edge, dtype=torch.int32,
                           device=dev)
        out_s = torch.zeros((b_rows, d), dtype=torch.bool, device=dev)
        for b in range(self.n_buckets):
            s, e, w = self.starts[b], self.starts[b + 1], self.widths[b]
            if w > d:
                break
            hit = ((pos >= s) & (pos < e)).nonzero().squeeze(1)
            loc = pos[hit].long() - s
            out_n[hit, :w] = self.nbrs[b][loc]
            out_m[hit, :w] = self.nbr_mask[b][loc]
            out_e[hit, :w] = self.edge_ids[b][loc]
            out_s[hit, :w] = self.is_src[b][loc]
        return EllRows(out_n, out_m, out_e, out_s)

    def row_activation(self, ids: torch.Tensor,
                       sel: torch.Tensor) -> torch.Tensor:
        """Route selected batch slots to their bucketed rows:
        ``[total_rows]`` bool.  When split, a selected owner activates
        all of its virtual rows (each chunk holds a slice of its
        scope)."""
        act = torch.zeros(self.total_rows, dtype=torch.bool,
                          device=self.device)
        ids = ids[sel].long()
        if self.w_cap is None:
            act[self.inv_perm[ids].long()] = True
            return act
        off = self.vrow_offset
        first = off[ids].long()
        k = torch.arange(self.n_chunks_max, device=self.device)
        vid = first[:, None] + k
        vid = vid[k < (off[ids + 1].long() - first)[:, None]]
        act[self.inv_perm[vid].long()] = True
        return act

    def to_padded(self) -> EllRows:
        """The monolithic ``[n_rows, max_deg]`` view (tests, oracles)."""
        return self.rows(torch.arange(self.n_rows, device=self.device))

    def to(self, device) -> "SlicedEll":
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self, slots=EllRows(*(t.to(device) for t in self.slots)),
            perm=self.perm.to(device), inv_perm=self.inv_perm.to(device),
            owner_of_vrow=move(self.owner_of_vrow),
            vrow_offset=move(self.vrow_offset))


def block_offsets(starts: Sequence[int],
                  widths: Sequence[int]) -> tuple[list[int], int]:
    """Where each bucket's block starts in the flat stores (a multiple
    of ``SLOT_ALIGN``), and the index of the last slot, the pad slot."""
    offs, o = [], 0
    for b, w in enumerate(widths):
        offs.append(o)
        o += -(-(starts[b + 1] - starts[b]) * w // SLOT_ALIGN) * SLOT_ALIGN
    return offs, o


def flat_slots(blocks: Sequence[Sequence[np.ndarray]], starts, widths,
               pad_edge: int, device) -> EllRows:
    """The flat stores of ``SlicedEll.slots`` from per-bucket host blocks
    ``(nbrs, nbr_mask, edge_ids, is_src)``, copied to ``device`` once."""
    offs, pad = block_offsets(starts, widths)
    out = []
    for arrs, fill, dtype in zip(blocks, (0, False, pad_edge, False),
                                 (np.int32, bool, np.int32, bool)):
        flat = np.full(pad + 1, fill, dtype)
        for o, a in zip(offs, arrs):
            a = np.asarray(a).reshape(-1)
            flat[o: o + a.size] = a
        out.append(torch.from_numpy(flat).to(device))
    return EllRows(*out)


def bucket_major_edge_order(ell: SlicedEll, n_edges: int) -> np.ndarray:
    """Edge ids in bucket-major first-visit order: ``order[new] = old``.

    Walking buckets in width order, rows in bucketed position order and
    slots left to right, an edge is numbered at its first appearance.
    Host-side, build-time only.
    """
    visits = [ell.edge_ids[b].cpu().numpy()[ell.nbr_mask[b].cpu().numpy()]
              for b in range(ell.n_buckets)]
    flat = (np.concatenate(visits) if visits
            else np.zeros(0, np.int64)).astype(np.int64)
    _, first = np.unique(flat, return_index=True)
    order = flat[np.sort(first)]
    if len(order) != n_edges:
        raise ValueError("every edge must appear in some row")
    return order


def _renumber_edge_ids(ell: SlicedEll, inv_order: np.ndarray,
                       n_edges: int) -> SlicedEll:
    """Map every stored edge id through ``inv_order`` (the pad id is a
    fixed point)."""
    table = np.arange(ell.pad_edge + 1, dtype=np.int32)
    table[:n_edges] = inv_order
    table = torch.from_numpy(table).to(ell.device)
    eids = table[ell.slots.edge_ids.long()]
    return dataclasses.replace(ell, slots=ell.slots._replace(edge_ids=eids))


def default_bucket_widths(max_deg: int) -> tuple[int, ...]:
    """Power-of-two widths 2, 4, ... capped by (and ending at) max_deg."""
    out, w = [], 2
    while w < max_deg:
        out.append(w)
        w *= 2
    out.append(max(max_deg, 1))
    return tuple(out)


def bucket_index(widths, slot_cnt: np.ndarray) -> np.ndarray:
    """The bucket of each row: the smallest width covering its slot
    count (zero-slot rows to the first bucket)."""
    return np.searchsorted(np.asarray(widths), np.maximum(slot_cnt, 1))


def build_sliced_ell(nbrs: np.ndarray, nbr_mask: np.ndarray,
                     edge_ids: np.ndarray, is_src: np.ndarray,
                     pad_edge: int, widths: Sequence[int] | None = None,
                     device=None) -> SlicedEll:
    """Bucket host-side padded ELL arrays into a ``SlicedEll``.

    Each row goes to the smallest bucket whose width covers its real
    slot count; within a bucket, rows keep ascending id order; empty
    buckets are dropped.  The blocks are built on the host and copied
    to ``device`` once, as one flat store each (``flat_slots``).
    """
    device = resolve_device(device)
    n_rows, d = nbrs.shape
    slot_cnt = nbr_mask.sum(axis=1)
    widths = tuple(widths) if widths is not None \
        else default_bucket_widths(int(d))
    if n_rows and widths[-1] < int(slot_cnt.max()):
        raise ValueError("bucket ladder must cover every row's slot count")
    bidx = bucket_index(widths, slot_cnt)
    groups = [np.nonzero(bidx == b)[0] for b in range(len(widths))]
    keep = [b for b in range(len(widths)) if len(groups[b])] or [0]
    widths = tuple(widths[b] for b in keep)
    groups = [groups[b] for b in keep]
    sizes = [len(g) for g in groups]

    starts = (0, *np.cumsum(sizes).tolist())
    perm = np.full(starts[-1], n_rows, dtype=np.int32)
    inv_perm = np.zeros(n_rows, dtype=np.int32)
    up = lambda a: torch.from_numpy(a).to(device)
    bn, bm, be, bs = [], [], [], []
    for b, (g, w) in enumerate(zip(groups, widths)):
        we = min(w, int(d))
        nb = np.zeros((sizes[b], w), np.int32)
        mk = np.zeros((sizes[b], w), bool)
        ei = np.full((sizes[b], w), pad_edge, np.int32)
        sr = np.zeros((sizes[b], w), bool)
        nb[:, :we] = nbrs[g, :we]
        mk[:, :we] = nbr_mask[g, :we]
        ei[:, :we] = edge_ids[g, :we]
        sr[:, :we] = is_src[g, :we]
        perm[starts[b]: starts[b + 1]] = g
        inv_perm[g] = np.arange(starts[b], starts[b + 1])
        bn.append(nb)
        bm.append(mk)
        be.append(ei)
        bs.append(sr)
    return SlicedEll(
        widths=widths, starts=starts, n_rows=n_rows, max_deg=int(d),
        pad_edge=int(pad_edge),
        slots=flat_slots((bn, bm, be, bs), starts, widths, pad_edge, device),
        perm=up(perm), inv_perm=up(inv_perm))


# ----------------------------------------------------------------------
# Hub splitting: virtual rows of width <= w_cap (host side, build time)
# ----------------------------------------------------------------------

def default_w_cap(degrees) -> int:
    """The smallest power of two covering the 99th-percentile degree,
    clamped to [2, 64]: rows past the p99 knee split into chunks, the
    bulk stay single-chunk."""
    deg = np.asarray(degrees, dtype=np.int64)
    target = int(np.quantile(deg, 0.99)) if deg.size else 2
    w = 2
    while w < min(max(target, 2), 64):
        w *= 2
    return w


def split_hub_rows(nbrs: np.ndarray, nbr_mask: np.ndarray,
                   edge_ids: np.ndarray, is_src: np.ndarray,
                   pad_edge: int, w_cap: int):
    """Chunk padded-ELL rows into ``[n_virtual, w_cap]`` virtual rows.

    Row ``r`` with ``c`` real slots (prefix-filled) becomes
    ``ceil(c / w_cap)`` virtual rows, at least one, chunk ``k`` holding
    slots ``[k*w_cap, (k+1)*w_cap)``; columns past the padded width
    carry the padding values.  Returns ``(nbrs, mask, edge_ids, is_src,
    owner [n_virtual] int64, vrow_offset [n + 1] int64)``.
    """
    n, d = nbrs.shape
    slot_cnt = nbr_mask.sum(axis=1).astype(np.int64)
    nchunks = np.maximum(1, -(-slot_cnt // w_cap))
    vrow_offset = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(nchunks, out=vrow_offset[1:])
    owner = np.repeat(np.arange(n, dtype=np.int64), nchunks)
    chunk = np.arange(len(owner), dtype=np.int64) - vrow_offset[owner]
    cols = chunk[:, None] * w_cap + np.arange(w_cap, dtype=np.int64)
    valid = cols < d
    safe = np.minimum(cols, max(d - 1, 0))
    rows = owner[:, None]
    vn = np.where(valid, nbrs[rows, safe], 0).astype(np.int32)
    vm = valid & nbr_mask[rows, safe]
    ve = np.where(valid, edge_ids[rows, safe], pad_edge).astype(np.int32)
    vs = valid & is_src[rows, safe]
    return vn, vm, ve, vs, owner, vrow_offset


def build_split_ell(nbrs: np.ndarray, nbr_mask: np.ndarray,
                    edge_ids: np.ndarray, is_src: np.ndarray,
                    pad_edge: int, w_cap: int, device=None) -> SlicedEll:
    """Hub-split a padded ELL and bucket the virtual rows on the
    ``default_bucket_widths(w_cap)`` ladder: the widest stored block is
    ``w_cap`` whatever the skew."""
    n, d = nbrs.shape
    vn, vm, ve, vs, owner, off = split_hub_rows(
        nbrs, nbr_mask, edge_ids, is_src, pad_edge, w_cap)
    device = resolve_device(device)
    ell = build_sliced_ell(vn, vm, ve, vs, pad_edge=pad_edge,
                           widths=default_bucket_widths(w_cap),
                           device=device)
    up = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)
    return dataclasses.replace(
        ell, n_rows=n, max_deg=int(d), w_cap=int(w_cap),
        n_chunks_max=int((off[1:] - off[:-1]).max()) if n else 1,
        owner_of_vrow=up(owner), vrow_offset=up(off))


# ----------------------------------------------------------------------
# Padded-ELL builder (host side)
# ----------------------------------------------------------------------

def _build_ell_vectorized(n_vertices: int, edges: np.ndarray, md: int):
    """Vectorized padded-ELL build (lexsort/cumsum slot assignment), a
    copy of the reference's, including its self-loop semantics (both
    endpoint writes share one slot; the non-src write wins; the slot
    cursor advances once)."""
    ne = len(edges)
    nbrs = np.zeros((n_vertices, md), dtype=np.int32)
    mask = np.zeros((n_vertices, md), dtype=bool)
    eids = np.full((n_vertices, md), ne, dtype=np.int32)
    is_src = np.zeros((n_vertices, md), dtype=bool)
    if ne == 0:
        return nbrs, mask, eids, is_src

    flat_v = edges.reshape(-1)                    # u0, v0, u1, v1, ...
    # slot of occurrence k = prior occurrences of that vertex, counting a
    # self-loop's two occurrences once
    vside_selfloop = np.zeros(2 * ne, dtype=np.int64)
    vside_selfloop[1::2] = edges[:, 0] == edges[:, 1]
    order = np.argsort(flat_v, kind="stable")
    sv = flat_v[order]
    boundary = np.ones(2 * ne, dtype=bool)
    boundary[1:] = sv[1:] != sv[:-1]
    group_id = np.cumsum(boundary) - 1
    group_start = np.nonzero(boundary)[0]
    rank_sorted = np.arange(2 * ne) - group_start[group_id]
    cum = np.cumsum(vside_selfloop[order])
    before_group = np.concatenate([[0], cum])[group_start]
    slot_sorted = rank_sorted - (cum - before_group[group_id])
    slot = np.empty(2 * ne, dtype=np.int64)
    slot[order] = slot_sorted

    nbr_flat = edges[:, ::-1].reshape(-1)         # v0, u0, v1, u1, ...
    eid_flat = np.repeat(np.arange(ne, dtype=np.int64), 2)
    src_flat = np.tile(np.asarray([True, False]), ne)
    nbrs[flat_v, slot] = nbr_flat
    mask[flat_v, slot] = True
    eids[flat_v, slot] = eid_flat
    src_flat[1::2] = edges[:, 0] == edges[:, 1]
    is_src[flat_v, slot] = src_flat
    return nbrs, mask, eids, is_src


# ----------------------------------------------------------------------
@dataclasses.dataclass
class DataGraph:
    """Static graph structure + mutable vertex/edge data (tensors)."""

    n_vertices: int
    n_edges: int
    max_deg: int
    ell: SlicedEll
    degree: torch.Tensor       # [Nv] int32
    vertex_data: dict          # name -> [Nv, ...]
    edge_data: dict            # name -> [n_edges + 1, ...] (last row = pad)
    edges_np: np.ndarray       # [n_edges, 2] int64, stored edge order
    colors: torch.Tensor | None = None   # [Nv] int32
    n_colors: int = 0
    # edge_perm[new] = input-order edge id; edge_inv_perm[input] = new
    edge_perm: np.ndarray | None = None
    edge_inv_perm: np.ndarray | None = None

    @property
    def device(self) -> torch.device:
        return self.ell.device

    @staticmethod
    def from_edges(
        n_vertices: int,
        edges: np.ndarray,
        vertex_data: dict,
        edge_data: dict | None = None,
        max_deg: int | None = None,
        bucket_widths: Sequence[int] | None = None,
        edge_locality: bool = True,
        hub_split: bool = False,
        w_cap: int | None = None,
        width_policy: str | None = None,
        slack: int = 0,
        device=None,
    ) -> "DataGraph":
        """Build the sliced-ELL structure from an undirected edge list.

        ``edges``: [Ne, 2] integer array, each row an undirected edge
        {u, v}.  ``edge_locality`` renumbers edge rows into bucket-major
        first-visit order (``edge_data`` is given in input order and
        permuted here; ``edge_perm`` maps back).  Data values may be
        numpy arrays or tensors; they keep their dtype.  Tensors go to
        ``device`` (default: the GPU, see ``resolve_device``).

        ``hub_split`` / ``w_cap`` chunk rows wider than ``w_cap`` (a
        power of two >= 2; default ``default_w_cap`` of the degrees)
        into virtual rows, so no stored block is wider than ``w_cap``.
        ``w_cap`` implies ``hub_split``; a graph whose max degree fits
        ``w_cap`` stays unsplit.  The illegal values and combinations
        raise the reference's ``ValueError``s.
        """
        device = resolve_device(device)
        if width_policy not in (None, "pow2", "measured"):
            raise ValueError(
                f"unknown width_policy {width_policy!r}: expected one "
                f"of (None, 'pow2', 'measured')")
        if width_policy == "measured" and (
                hub_split or w_cap is not None or bucket_widths is not None):
            raise ValueError(
                "width_policy='measured' chooses the bucket ladder "
                "itself; legal combinations: width_policy='measured' "
                "alone, or bucket_widths/hub_split/w_cap with the "
                "default policy")
        if w_cap is not None:
            legal = "a power of two >= 2 (e.g. 2, 4, ..., 64)"
            if isinstance(w_cap, bool) \
                    or not isinstance(w_cap, (int, np.integer)) \
                    or w_cap < 2 or (w_cap & (w_cap - 1)):
                raise ValueError(
                    f"w_cap={w_cap!r}: legal values are {legal}")
            hub_split = True
        if hub_split and bucket_widths is not None:
            raise ValueError(
                "hub_split uses the default_bucket_widths(w_cap) ladder; "
                "legal combinations: bucket_widths alone, or "
                "hub_split/w_cap alone")
        if isinstance(slack, bool) or not isinstance(slack, (int, np.integer)) \
                or slack < 0:
            raise ValueError(f"slack must be a non-negative int, got {slack!r}")
        if slack and (hub_split or width_policy == "measured"
                      or bucket_widths is not None):
            raise ValueError(
                "slack= (mutable storage) is incompatible with "
                "hub_split/w_cap/width_policy='measured'/bucket_widths: "
                "those pick bucket ladders with no insert headroom; legal "
                "combinations: slack alone, or the frozen-storage options "
                "alone")
        if width_policy == "measured":
            raise NotImplementedError(
                "width_policy='measured' (width plans scored by a fitted "
                "cost model) is not ported to repro_torch yet: ROADMAP A8")
        if slack:
            raise NotImplementedError(
                "slack= (mutable storage) is not ported to repro_torch "
                "yet: ROADMAP A11")
        edges = np.asarray(edges, dtype=np.int64)
        if edges.size == 0:
            edges = edges.reshape(0, 2)
        ne = len(edges)
        deg = (np.bincount(edges[:, 0], minlength=n_vertices)
               + np.bincount(edges[:, 1], minlength=n_vertices))
        md = int(deg.max()) if ne else 1
        if max_deg is not None:
            if max_deg < md:
                raise ValueError(f"max_deg={max_deg} < actual max degree {md}")
            md = max_deg
        md = max(md, 1)

        nbrs, mask, eids, is_src = _build_ell_vectorized(
            n_vertices, edges, md)
        if hub_split and w_cap is None:
            w_cap = default_w_cap(np.maximum(deg, 1))
        if hub_split and md > w_cap:
            ell = build_split_ell(nbrs, mask, eids, is_src, pad_edge=ne,
                                  w_cap=int(w_cap), device=device)
        else:
            ell = build_sliced_ell(nbrs, mask, eids, is_src, pad_edge=ne,
                                   widths=bucket_widths, device=device)
        del nbrs, mask, eids, is_src

        edge_data = _tensor_dict(edge_data, device)
        if edge_locality and ne:
            order = bucket_major_edge_order(ell, ne)
            inv_order = np.empty(ne, dtype=np.int64)
            inv_order[order] = np.arange(ne)
            ell = _renumber_edge_ids(ell, inv_order, ne)
            edges = edges[order]
            sel = torch.from_numpy(order).to(device)
            edge_data = {k: v[sel] for k, v in edge_data.items()}
        else:
            order = np.arange(ne, dtype=np.int64)
            inv_order = order.copy()
        # the pad edge row last, all zeros
        edge_data = {k: torch.cat([v, v.new_zeros((1,) + v.shape[1:])])
                     for k, v in edge_data.items()}
        return DataGraph(
            n_vertices=n_vertices,
            n_edges=ne,
            max_deg=md,
            ell=ell,
            degree=torch.from_numpy(deg.astype(np.int32)).to(device),
            vertex_data=_tensor_dict(vertex_data, device),
            edge_data=edge_data,
            edges_np=edges,
            edge_perm=order,
            edge_inv_perm=inv_order,
        )

    # -- structure access ----------------------------------------------
    @property
    def n_rows(self) -> int:
        """Row-id space (the number of addressable rows)."""
        return self.n_vertices

    def struct_rows(self, ids: torch.Tensor,
                    width: int | None = None) -> EllRows:
        """Adjacency rows for a batch of vertex ids."""
        return self.ell.rows(ids, width=width)

    def to_padded(self) -> EllRows:
        """Monolithic ``[Nv, max_deg]`` view (oracle / test escape hatch)."""
        return self.ell.to_padded()

    @property
    def adjacency_lists(self) -> list[list[int]]:
        """Host-side adjacency in stored edge order (the sequential
        oracle's locking replay reads it)."""
        adj: list[list[int]] = [[] for _ in range(self.n_vertices)]
        for u, v in self.edges_np.tolist():
            adj[u].append(v)
            adj[v].append(u)
        return adj

    # ------------------------------------------------------------------
    def with_colors(self, colors: np.ndarray) -> "DataGraph":
        colors = np.asarray(colors)
        return dataclasses.replace(
            self,
            colors=torch.from_numpy(colors.astype(np.int32)).to(self.device),
            n_colors=int(colors.max()) + 1 if colors.size else 1,
        )

    def to(self, device) -> "DataGraph":
        """The same graph with every tensor on ``device``."""
        device = torch.device(device)
        return dataclasses.replace(
            self, ell=self.ell.to(device), degree=self.degree.to(device),
            vertex_data=_tensor_dict(self.vertex_data, device),
            edge_data=_tensor_dict(self.edge_data, device),
            colors=None if self.colors is None else self.colors.to(device))


# ----------------------------------------------------------------------
# Generators (host side)
# ----------------------------------------------------------------------

def bipartite_edges(n_left: int, n_right: int,
                    pairs: np.ndarray) -> tuple[int, np.ndarray]:
    """Map (left_i, right_j) pairs to global vertex ids: left vertices
    get ids [0, n_left), right vertices [n_left, n_left+n_right)."""
    pairs = np.asarray(pairs, dtype=np.int64)
    edges = np.stack([pairs[:, 0], pairs[:, 1] + n_left], axis=1)
    return n_left + n_right, edges


def grid_edges_3d(nx: int, ny: int, nz: int) -> tuple[int, np.ndarray]:
    """6-connected 3-D grid (the CoSeg super-pixel graph, paper §5.2),
    edges in the reference's (x, y, z, then +x/+y/+z) order."""
    vid = np.arange(nx * ny * nz, dtype=np.int64).reshape(nx, ny, nz)
    cand = np.full((nx, ny, nz, 3, 2), -1, dtype=np.int64)
    cand[:-1, :, :, 0, 0] = vid[:-1]
    cand[:-1, :, :, 0, 1] = vid[1:]
    cand[:, :-1, :, 1, 0] = vid[:, :-1]
    cand[:, :-1, :, 1, 1] = vid[:, 1:]
    cand[:, :, :-1, 2, 0] = vid[:, :, :-1]
    cand[:, :, :-1, 2, 1] = vid[:, :, 1:]
    cand = cand.reshape(-1, 2)
    return nx * ny * nz, cand[cand[:, 0] >= 0]


def zipf_edges(n_vertices: int, alpha: float = 2.0,
               max_deg: int | None = None, seed: int = 0) -> np.ndarray:
    """Power-law degree graph via the configuration model: Zipf(alpha)
    degrees (optionally clipped to ``max_deg``), stubs paired uniformly
    at random, self loops and duplicate edges dropped.  The same numpy
    calls as the reference, so the same seed gives the same edges."""
    rng = np.random.default_rng(seed)
    deg = rng.zipf(alpha, n_vertices)
    if max_deg is not None:
        deg = np.minimum(deg, max_deg)
    stubs = np.repeat(np.arange(n_vertices, dtype=np.int64), deg)
    rng.shuffle(stubs)
    pairs = stubs[: 2 * (len(stubs) // 2)].reshape(-1, 2)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    lo = np.minimum(pairs[:, 0], pairs[:, 1])
    hi = np.maximum(pairs[:, 0], pairs[:, 1])
    return np.unique(np.stack([lo, hi], axis=1), axis=0)
