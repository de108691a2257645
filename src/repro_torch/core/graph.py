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
reference does; ``width_policy="measured"`` picks the ladder (split or
not) a fitted cost model prices cheapest (``choose_width_plan``).

Mutation slack (``from_edges(slack=)``, DESIGN.md §13) reserves free
slots in every row and spare edge rows, so ``insert_edges`` lands new
edges without a rebuild; ``rebuild_compacted`` is the slow path when
the slack runs out.  Neither ever writes a tensor of the graph it was
given: every write is to a new tensor, so a reader holding the old
graph's tensors (a published serving snapshot) never sees it.
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

# the most slots a store may hold: ``_row_offset``, the flat gather's
# indices and the plan's regrouping address them in int32 (Netflix's
# 100 M ratings take 2.9e8 stored slots)
MAX_STORE_SLOTS = 2 ** 31 - 1

# ``SlicedEll.regrouped``: a (key, width) group joins the next wider
# group of its key where its rows, padded to that width, add at most
# this share of the joined block's slots.  Each group of a chromatic
# phase runs its own gather, update (a dense update's whole body) and
# combine launches on the host, which cost more than a few padded slots
# on the device: an Ising grid's border rows, a group of their own in
# each color, doubled a Gibbs sweep's launches
JOIN_PAD_SHARE = 1 / 64


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
        if pad >= MAX_STORE_SLOTS:
            raise ValueError(f"the flat stores would hold {pad + 1} slots; "
                             f"row offsets and gathers index them in int32 "
                             f"(at most {MAX_STORE_SLOTS})")
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

    def regrouped(self, keys: torch.Tensor, n_keys: int) -> tuple:
        """The same rows stored again, grouped by (``keys[row]``, the
        row's bucket here) in key-major order, rows ascending within a
        bucket, each group one block at its bucket's width here: every
        row's stored slots copied on the device (unsplit storage).  A
        group joins the next wider group of its key, its rows padded to
        that width, where that pads at most ``JOIN_PAD_SHARE`` of the
        joined block's slots.  Returns the new ``SlicedEll`` and, for
        each key ``0..n_keys-1``, ``(ids, rows, offsets)``: its rows in
        block order, each group's ``EllRows`` block and where each
        group starts in ``ids`` (and the end)."""
        dev = self.device
        bucket = torch.searchsorted(self._ends, self.inv_perm, right=True)
        key = keys.to(dev).long() * self.n_buckets + bucket
        order = torch.sort(key, stable=True).indices
        group_keys, sizes, widths, stored = [], [], [], []
        for k, n in zip(*(t.tolist() for t in torch.unique_consecutive(
                key[order], return_counts=True))):
            w = self.widths[k % self.n_buckets]
            if (group_keys and group_keys[-1] // self.n_buckets
                    == k // self.n_buckets and sizes[-1] * w - stored[-1]
                    <= JOIN_PAD_SHARE * (sizes[-1] + n) * w):
                sizes[-1] += n
                stored[-1] += n * w
                widths[-1] = w
                continue
            group_keys.append(k)
            sizes.append(n)
            widths.append(w)
            stored.append(n * w)
        widths = tuple(widths)
        starts = (0, *np.cumsum(sizes).tolist())
        offs, pad = block_offsets(starts, widths)
        pos = self.inv_perm.long()[order]
        first, width = self._row_offset[pos], self._row_width[pos]
        flat = [torch.full((pad + 1,), fill, dtype=s.dtype, device=dev)
                for s, fill in zip(self.slots,
                                   (0, False, self.pad_edge, False))]
        for g, w in enumerate(widths):
            a, b = starts[g], starts[g + 1]
            cols = torch.arange(w, dtype=torch.int32, device=dev)
            idx = first[a:b, None] + cols
            idx.masked_fill_(cols >= width[a:b, None], self._pad_slot)
            idx = idx.view(-1).long()
            for dst, src in zip(flat, self.slots):
                dst[offs[g]: offs[g] + idx.numel()] = src[idx]
        inv_perm = torch.empty_like(self.inv_perm)
        inv_perm[order] = torch.arange(self.n_rows, dtype=inv_perm.dtype,
                                       device=dev)
        store = SlicedEll(widths=widths, starts=starts, n_rows=self.n_rows,
                          max_deg=self.max_deg, pad_edge=self.pad_edge,
                          slots=EllRows(*flat), perm=order.int(),
                          inv_perm=inv_perm)
        bounds = np.searchsorted(np.asarray(group_keys) // self.n_buckets,
                                 np.arange(n_keys + 1)).tolist()
        out = []
        for g0, g1 in zip(bounds[:-1], bounds[1:]):
            s0 = store.starts[g0]
            out.append((store.perm[s0: store.starts[g1]],
                        tuple(EllRows(store.nbrs[g], store.nbr_mask[g],
                                      store.edge_ids[g], store.is_src[g])
                              for g in range(g0, g1)),
                        tuple(store.starts[g] - s0
                              for g in range(g0, g1 + 1))))
        return store, out

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
    That walk is the flat stores' real slots in store order (the blocks
    lie in bucket order, each row-major, the gaps padding).  Build time
    only, on the storage's device: a stable sort finds each edge's first
    visit, bitwise ``np.unique(..., return_index=True)``'s.
    """
    flat = ell.slots.edge_ids[ell.slots.nbr_mask].long()
    ids, pos = torch.sort(flat, stable=True)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    order = flat[torch.sort(pos[first]).values].cpu().numpy()
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


def _bucket_groups(widths, slot_cnt, bucket_sizes):
    """Rows of each bucket (ascending ids) and the bucket sizes: empty
    buckets dropped, or, with ``bucket_sizes``, every bucket kept at the
    forced row count (padded with empty rows, as a ``ShardPlan`` keeps
    one shape across shards)."""
    bidx = bucket_index(widths, slot_cnt)
    order = np.argsort(bidx, kind="stable")
    cuts = np.searchsorted(bidx[order], np.arange(len(widths) + 1))
    groups = [order[cuts[b]: cuts[b + 1]] for b in range(len(widths))]
    if bucket_sizes is None:
        keep = [b for b in range(len(widths)) if len(groups[b])] or [0]
        widths = tuple(widths[b] for b in keep)
        groups = [groups[b] for b in keep]
        return widths, groups, [len(g) for g in groups]
    sizes = [int(s) for s in bucket_sizes]
    if len(sizes) != len(widths) or any(s < len(g)
                                        for s, g in zip(sizes, groups)):
        raise ValueError("bucket_sizes must give every bucket at least "
                         "its rows")
    return tuple(widths), groups, sizes


def build_sliced_ell(nbrs: np.ndarray, nbr_mask: np.ndarray,
                     edge_ids: np.ndarray, is_src: np.ndarray,
                     pad_edge: int, widths: Sequence[int] | None = None,
                     device=None) -> SlicedEll:
    """Bucket host-side padded ELL arrays into a ``SlicedEll``.

    Each row goes to the smallest bucket whose width covers its real
    slot count; within a bucket, rows keep ascending id order; empty
    buckets are dropped.  The rows' real slots (a prefix of each row)
    are laid out by ``sliced_ell_from_slots``, the one builder.
    """
    d = int(nbrs.shape[1])
    return sliced_ell_from_slots(
        *padded_slots(nbrs, nbr_mask, edge_ids, is_src), pad_edge,
        default_bucket_widths(d) if widths is None else widths, d,
        device=device)


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


def candidate_width_plans(slot_cnt, max_deg: int) -> list[dict]:
    """Width-set candidates ``width_policy="measured"`` scores.

    One unsplit pow2-ladder plan plus one hub-split plan per legal
    ``w_cap`` in 4..64, each carrying the ``(width, rows)`` launch
    sequence a full bucket sweep would run under that ladder — computed
    from per-row real slot counts by the chunking rule
    ``virtual_rows`` applies (full ``w_cap``-wide chunks land in the
    top bucket, the remainder chunk in its covering bucket, zero-slot
    rows in bucket 0).  Scoring only: no plan is built.
    """
    cnt = np.maximum(np.asarray(slot_cnt, np.int64), 0)
    md = max(int(max_deg), 1)

    def launches(widths, counts):
        return tuple((int(w), int(c)) for w, c in zip(widths, counts) if c)

    widths = default_bucket_widths(md)
    counts = np.bincount(bucket_index(widths, cnt), minlength=len(widths))
    plans = [{"hub_split": False, "w_cap": None, "widths": widths,
              "launches": launches(widths, counts)}]
    cap = 4
    while cap < md and cap <= 64:
        wc = default_bucket_widths(cap)
        full, rem = cnt // cap, cnt % cap
        has_rem = (rem > 0) | (cnt == 0)
        counts = np.bincount(bucket_index(wc, rem[has_rem]),
                             minlength=len(wc))
        counts[-1] += int(full.sum())
        plans.append({"hub_split": True, "w_cap": cap, "widths": wc,
                      "launches": launches(wc, counts)})
        cap *= 2
    return plans


def choose_width_plan(slot_cnt, max_deg: int, cost_model) -> dict | None:
    """Cheapest candidate plan under a fitted cost model's predicted
    sweep time; ties keep the earlier candidate (the unsplit ladder
    comes first).  ``None`` when no candidate is predictable — callers
    fall back to the pow2 default."""
    best = None
    for plan in candidate_width_plans(slot_cnt, max_deg):
        t = cost_model.predict_launches(plan["launches"])
        if t is None:
            continue
        if best is None or t < best[0]:
            best = (t, plan)
    return None if best is None else best[1]


def virtual_rows(seg_start: np.ndarray, cnt: np.ndarray, w_cap: int):
    """Hub-split row slot lists: row ``r`` with ``c`` real slots becomes
    ``ceil(c / w_cap)`` virtual rows, at least one, chunk ``k`` holding
    its slots ``[k*w_cap, (k+1)*w_cap)``.  Returns ``(seg_start, counts,
    owner, vrow_offset [rows + 1])`` of the virtual rows (int64)."""
    seg_start = np.asarray(seg_start, np.int64)
    cnt = np.asarray(cnt, np.int64)
    nchunks = np.maximum(1, -(-cnt // w_cap))
    vrow_offset = np.zeros(len(cnt) + 1, dtype=np.int64)
    np.cumsum(nchunks, out=vrow_offset[1:])
    owner = np.repeat(np.arange(len(cnt), dtype=np.int64), nchunks)
    chunk = np.arange(len(owner), dtype=np.int64) - vrow_offset[owner]
    vcnt = np.clip(cnt[owner] - chunk * w_cap, 0, w_cap)
    return seg_start[owner] + chunk * w_cap, vcnt, owner, vrow_offset


def split_ell_from_slots(seg_start: np.ndarray, cnt: np.ndarray,
                         flat: tuple, pad_edge: int, w_cap: int,
                         max_deg: int, widths: Sequence[int] | None = None,
                         bucket_sizes: Sequence[int] | None = None,
                         n_virtual: int | None = None,
                         device=None) -> SlicedEll:
    """Hub-split row slot lists (as ``sliced_ell_from_slots`` takes
    them) and bucket the virtual rows on the
    ``default_bucket_widths(w_cap)`` ladder (or ``widths``): the widest
    stored block is ``w_cap`` whatever the skew.  ``bucket_sizes`` and
    ``n_virtual`` force one shape across a ``ShardPlan``'s shards: dummy
    virtual rows are empty, owned by the ``rows`` sentinel, and land in
    bucket 0."""
    n = len(cnt)
    vseg, vcnt, owner, off = virtual_rows(seg_start, cnt, w_cap)
    if n_virtual is not None:
        extra = n_virtual - len(owner)
        if extra < 0:
            raise ValueError("n_virtual below the virtual-row count")
        vseg = np.concatenate([vseg, np.zeros(extra, np.int64)])
        vcnt = np.concatenate([vcnt, np.zeros(extra, np.int64)])
        owner = np.concatenate([owner, np.full(extra, n, np.int64)])
    device = resolve_device(device)
    ell = sliced_ell_from_slots(
        vseg, vcnt, flat, pad_edge,
        default_bucket_widths(w_cap) if widths is None else widths, w_cap,
        bucket_sizes=bucket_sizes, device=device)
    up = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)
    return dataclasses.replace(
        ell, n_rows=n, max_deg=int(max_deg), w_cap=int(w_cap),
        n_chunks_max=int((off[1:] - off[:-1]).max()) if n else 1,
        owner_of_vrow=up(owner), vrow_offset=up(off))


def build_split_ell(nbrs: np.ndarray, nbr_mask: np.ndarray,
                    edge_ids: np.ndarray, is_src: np.ndarray,
                    pad_edge: int, w_cap: int, device=None) -> SlicedEll:
    """Hub-split a padded ELL (``split_ell_from_slots`` on its rows'
    real slots)."""
    return split_ell_from_slots(
        *padded_slots(nbrs, nbr_mask, edge_ids, is_src), pad_edge, w_cap,
        int(nbrs.shape[1]), device=device)


# ----------------------------------------------------------------------
# Row slot lists (host side): the sliced storage without its padding
# ----------------------------------------------------------------------

def row_slots(ell: SlicedEll) -> tuple[np.ndarray, tuple]:
    """Every stored row's real slots, in slot order, on the host:
    ``(counts [rows] int64, (nbrs, edge_ids, is_src))`` with the slot
    arrays flat and row after row.  The rows are the owner rows, a
    split row's chunks joined in order (real slots are a prefix of every
    padded row, so the chunks of a hub join into its unsplit row)."""
    slots = [s.cpu().numpy() for s in ell.slots]
    offs, _ = block_offsets(ell.starts, ell.widths)
    sizes = np.diff(np.asarray(ell.starts, np.int64))
    b = np.repeat(np.arange(ell.n_buckets), sizes)
    local = np.arange(ell.total_rows) - np.asarray(ell.starts[:-1])[b]
    width = np.asarray(ell.widths, np.int64)[b]
    pos_off = np.asarray(offs, np.int64)[b] + local * width
    pos_cnt = np.concatenate([
        slots[1][o: o + n * w].reshape(n, w).sum(axis=1)
        for o, n, w in zip(offs, sizes, ell.widths)]).astype(np.int64)
    inv = ell.inv_perm.cpu().numpy().astype(np.int64)
    cnt = pos_cnt[inv]
    idx = segment_index(pos_off[inv], cnt)
    if not slots[1][idx].all():
        raise ValueError("a row's real slots must be a prefix of its row")
    if ell.w_cap is not None:
        off = ell.vrow_offset.cpu().numpy().astype(np.int64)
        cnt = np.add.reduceat(cnt, off[:-1]) if len(off) > 1 else cnt[:0]
    return cnt, (slots[0][idx], slots[2][idx], slots[3][idx])


def segment_index(start: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """``concat(arange(s, s + c) for s, c in zip(start, cnt))``."""
    total = int(cnt.sum())
    first = np.zeros(len(cnt), np.int64)
    np.cumsum(cnt[:-1], out=first[1:])
    return np.repeat(start - first, cnt) + np.arange(total, dtype=np.int64)


def padded_slots(nbrs: np.ndarray, nbr_mask: np.ndarray,
                 edge_ids: np.ndarray, is_src: np.ndarray):
    """Host padded ELL arrays as row slot lists: ``(seg_start [rows],
    counts [rows], (nbrs, edge_ids, is_src))``, the slot arrays flat and
    row after row.  Every row's real slots must be a prefix of it, as
    ``from_edges`` lays them out."""
    nbr_mask = np.asarray(nbr_mask, bool)
    n, d = nbr_mask.shape
    cnt = nbr_mask.sum(axis=1).astype(np.int64)
    lead = (np.where(nbr_mask.all(axis=1), d, nbr_mask.argmin(axis=1))
            if d else cnt)
    if not np.array_equal(lead, cnt):
        raise ValueError("a row's real slots must be a prefix of its row")
    start = np.zeros(n, np.int64)
    np.cumsum(cnt[:-1], out=start[1:])
    return start, cnt, (np.asarray(nbrs)[nbr_mask],
                        np.asarray(edge_ids)[nbr_mask],
                        np.asarray(is_src)[nbr_mask])


def sliced_ell_from_slots(seg_start: np.ndarray, seg_cnt: np.ndarray,
                          flat: tuple, pad_edge: int, widths: Sequence[int],
                          max_deg: int,
                          bucket_sizes: Sequence[int] | None = None,
                          device=None, slack: int = 0) -> SlicedEll:
    """A ``SlicedEll`` from row slot lists: row ``r``'s real slots are
    ``flat[*][seg_start[r]: seg_start[r] + seg_cnt[r]]`` (``flat =
    (nbrs, edge_ids, is_src)``).  Each row goes to the smallest bucket
    of ``widths`` covering its slot count plus ``slack`` (the free slots
    ``insert_edges`` fills), rows keep ascending id order within a
    bucket, and empty buckets are dropped, unless ``bucket_sizes``
    forces every bucket's row count (empty rows pad it; a ``ShardPlan``
    keeps its shards' shapes equal this way).  It writes the flat stores
    directly, so no ``[rows, max_deg]`` array is ever made."""
    device = resolve_device(device)
    seg_cnt = np.asarray(seg_cnt, np.int64)
    n_rows = len(seg_cnt)
    widths = tuple(widths)
    if n_rows and widths[-1] < int(seg_cnt.max()) + slack:
        raise ValueError("bucket ladder must cover every row's slot count"
                         + (" + slack" if slack else ""))
    widths, groups, sizes = _bucket_groups(widths, seg_cnt + slack,
                                           bucket_sizes)
    starts = (0, *np.cumsum(sizes).tolist())
    offs, pad = block_offsets(starts, widths)
    perm = np.full(starts[-1], n_rows, dtype=np.int32)
    inv_perm = np.zeros(n_rows, dtype=np.int32)
    base = np.zeros(n_rows, np.int64)
    for b, g in enumerate(groups):
        k = np.arange(len(g))
        perm[starts[b] + k] = g
        inv_perm[g] = starts[b] + k
        base[g] = offs[b] + k * widths[b]
    src = segment_index(np.asarray(seg_start, np.int64), seg_cnt)
    dst = segment_index(base, seg_cnt)
    out = []
    for vals, fill, dtype in zip((flat[0], None, flat[1], flat[2]),
                                 (0, False, pad_edge, False),
                                 (np.int32, bool, np.int32, bool)):
        a = np.full(pad + 1, fill, dtype)
        a[dst] = True if vals is None else vals[src]
        out.append(torch.from_numpy(a).to(device))
    up = lambda a: torch.from_numpy(a).to(device)
    return SlicedEll(widths=widths, starts=starts, n_rows=n_rows,
                     max_deg=int(max_deg), pad_edge=int(pad_edge),
                     slots=EllRows(*out), perm=up(perm),
                     inv_perm=up(inv_perm))


# ----------------------------------------------------------------------
# Padded-ELL builder (host side)
# ----------------------------------------------------------------------

def _build_ell_vectorized(n_vertices: int, edges: np.ndarray, md: int):
    """The reference's padded ELL arrays ``[Nv, md]`` (``nbrs``,
    ``mask``, ``edge_ids`` with the pad edge ``n_edges``, ``is_src``),
    laid out from ``edge_slot_lists``: the tests hold the padded
    builders against the reference's with them."""
    ne = len(edges)
    nbrs = np.zeros((n_vertices, md), dtype=np.int32)
    mask = np.zeros((n_vertices, md), dtype=bool)
    eids = np.full((n_vertices, md), ne, dtype=np.int32)
    is_src = np.zeros((n_vertices, md), dtype=bool)
    start, cnt, (f_nbr, f_eid, f_src) = edge_slot_lists(n_vertices, edges)
    rows = np.repeat(np.arange(n_vertices), cnt)
    slots = np.arange(int(cnt.sum())) - np.repeat(start, cnt)
    nbrs[rows, slots] = f_nbr
    mask[rows, slots] = True
    eids[rows, slots] = f_eid
    is_src[rows, slots] = f_src
    return nbrs, mask, eids, is_src


def stable_argsort(a: np.ndarray, device=None) -> np.ndarray:
    """``np.argsort(a, kind="stable")``, sorted by ``torch.sort(...,
    stable=True)`` on ``device`` (default: the CPU): a stable sort's
    permutation is unique, so the two are bitwise equal."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(
        "cpu" if device is None else device)
    return torch.sort(t, stable=True).indices.cpu().numpy()


def edge_slot_lists(n_vertices: int, edges: np.ndarray, device=None):
    """Every row's real slots, ``(seg_start, counts, (nbrs, edge_ids,
    is_src))`` as ``padded_slots`` returns them, straight from the edge
    list, with no ``[Nv, max_deg]`` array (5.4 GB at 2^21 vertices and
    width 260): the reference's vectorized slot rule.  Occurrence k of a
    vertex takes slot k, a self-loop's two occurrences counting once
    (the loop builder reads both cursors before either write); sorted
    by vertex the occurrences are in slot order, a self-loop's two
    writes adjacent, the later (its v side, ``is_src`` forced True)
    kept.  The sort by vertex runs on ``device`` (``stable_argsort``)."""
    ne = len(edges)
    if ne == 0:
        z = np.zeros(n_vertices, np.int64)
        return z, z.copy(), (np.zeros(0, np.int32), np.zeros(0, np.int32),
                             np.zeros(0, bool))
    flat_v = edges.reshape(-1)
    vside_selfloop = np.zeros(2 * ne, dtype=np.int64)
    vside_selfloop[1::2] = edges[:, 0] == edges[:, 1]
    order = stable_argsort(flat_v, device)
    sv = flat_v[order]
    boundary = np.ones(2 * ne, dtype=bool)
    boundary[1:] = sv[1:] != sv[:-1]
    group_id = np.cumsum(boundary) - 1
    group_start = np.nonzero(boundary)[0]
    rank_sorted = np.arange(2 * ne) - group_start[group_id]
    cum = np.cumsum(vside_selfloop[order])
    before_group = np.concatenate([[0], cum])[group_start]
    slot_sorted = rank_sorted - (cum - before_group[group_id])
    keep = np.ones(2 * ne, dtype=bool)
    keep[:-1] = boundary[1:] | (slot_sorted[1:] != slot_sorted[:-1])
    sel = order[keep]
    src_flat = np.tile(np.asarray([True, False]), ne)
    src_flat[1::2] = edges[:, 0] == edges[:, 1]
    cnt = np.bincount(sv[keep], minlength=n_vertices).astype(np.int64)
    start = np.zeros(n_vertices, np.int64)
    np.cumsum(cnt[:-1], out=start[1:])
    return start, cnt, (edges[:, ::-1].reshape(-1)[sel].astype(np.int32),
                        (sel // 2).astype(np.int32), src_flat[sel])


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
    # mutation slack: every row keeps >= ``slack`` free slots and edge
    # rows [n_edges, edge_capacity) are reserved for ``insert_edges``;
    # 0 is frozen storage
    slack: int = 0

    @property
    def device(self) -> torch.device:
        return self.ell.device

    @property
    def edge_capacity(self) -> int:
        """Edge rows the storage can address (``n_edges`` when built
        without slack); the pad edge row sits at this index."""
        return self.ell.pad_edge

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
        cost_model=None,
        slack: int = 0,
        edge_capacity: int | None = None,
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

        ``width_policy="measured"`` scores every candidate ladder (the
        unsplit pow2 ladder and each hub-split ``w_cap``,
        ``candidate_width_plans``) by a fitted cost model's predicted
        sweep time and builds the cheapest.  ``cost_model`` is anything
        ``repro_torch.profile.resolve_cost_model`` takes; unset, the
        calibration persisted for the type of ``device`` is loaded
        (``COSTMODEL_cuda.json`` for a card graph, never a CPU one), and
        with none the policy builds the pow2 default.

        ``slack`` reserves at least ``slack`` free slots in every row
        (the ladder reaches ``max_deg + slack``) and ``edge_capacity -
        n_edges`` zeroed edge rows (default ``n_edges + ceil(Nv * slack
        / 2)``, the most inserts the free slots can take), for
        ``insert_edges``.  Free slots are ordinary padding until an
        insert fills them.  Slack does not combine with hub splitting,
        ``width_policy="measured"`` or ``bucket_widths``.
        """
        device = resolve_device(device)
        if width_policy not in (None, "pow2", "measured"):
            raise ValueError(
                f"unknown width_policy {width_policy!r}: expected one "
                f"of (None, 'pow2', 'measured')")
        if cost_model is not None and width_policy != "measured":
            raise ValueError(
                "cost_model= only applies to width_policy='measured' "
                "(other policies never consult a model)")
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
        if edge_capacity is not None and slack == 0:
            raise ValueError(
                "edge_capacity= only applies to slack > 0 graphs (a frozen "
                "graph stores exactly n_edges rows)")
        if slack and (hub_split or width_policy == "measured"
                      or bucket_widths is not None):
            raise ValueError(
                "slack= (mutable storage, DESIGN.md §13) is incompatible "
                "with hub_split/w_cap/width_policy='measured'/"
                "bucket_widths: those pick bucket ladders with no insert "
                "headroom; legal combinations: slack alone, or the "
                "frozen-storage options alone")
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

        slot_lists = edge_slot_lists(n_vertices, edges, device)
        if width_policy == "measured":
            from repro_torch.profile.model import (load_cost_model,
                                                   resolve_cost_model)
            model = (resolve_cost_model(cost_model, device.type)
                     if cost_model is not None
                     else load_cost_model(device.type))
            plan = (choose_width_plan(slot_lists[1], md, model)
                    if model is not None else None)
            if plan is not None and plan["hub_split"]:
                hub_split, w_cap = True, plan["w_cap"]
        if hub_split and w_cap is None:
            w_cap = default_w_cap(np.maximum(deg, 1))
        if slack:
            # free columns for every row, and the padded slots pointing at
            # the capacity pad row: edge ids [ne, capacity) stay free
            cap = (ne + -(-n_vertices * slack // 2)
                   if edge_capacity is None else int(edge_capacity))
            if cap < ne:
                raise ValueError(
                    f"edge_capacity={cap} < n_edges={ne}: capacity must "
                    "cover the edges already present")
            md = md + slack
            ell = sliced_ell_from_slots(
                *slot_lists, cap, default_bucket_widths(md), md,
                device=device, slack=slack)
        elif hub_split and md > w_cap:
            ell = split_ell_from_slots(*slot_lists, ne, int(w_cap), md,
                                       device=device)
        else:
            ell = sliced_ell_from_slots(
                *slot_lists, ne, default_bucket_widths(md)
                if bucket_widths is None else bucket_widths, md,
                device=device)
        del slot_lists

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
        # the reserved edge rows (capacity - ne of them), then the pad
        # row last, all zeros
        spare = ell.pad_edge - ne + 1
        edge_data = {k: torch.cat([v, v.new_zeros((spare,) + v.shape[1:])])
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
            slack=int(slack),
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

    def replace_data(self, vertex_data=None,
                     edge_data=None) -> "DataGraph":
        """The graph with new vertex and/or edge data (a part left None
        is kept)."""
        return dataclasses.replace(
            self,
            vertex_data=(self.vertex_data if vertex_data is None
                         else vertex_data),
            edge_data=self.edge_data if edge_data is None else edge_data)

    def to(self, device) -> "DataGraph":
        """The same graph with every tensor on ``device``."""
        device = torch.device(device)
        return dataclasses.replace(
            self, ell=self.ell.to(device), degree=self.degree.to(device),
            vertex_data=_tensor_dict(self.vertex_data, device),
            edge_data=_tensor_dict(self.edge_data, device),
            colors=None if self.colors is None else self.colors.to(device))


# ----------------------------------------------------------------------
# Live mutations (DESIGN.md §13): slack inserts + compaction rebuild
# ----------------------------------------------------------------------

def _row_slot_counts(ell: SlicedEll) -> np.ndarray:
    """Real (mask-true) slots of every row on the host: the insert
    cursor.  Real slots are a prefix of every row (the builder and
    ``insert_edges`` both keep it so), so a row's next free column is
    its slot count, which is not its degree: a self-loop's two endpoint
    writes share one slot.  Unsplit storage (slack graphs never split)."""
    offs, _ = block_offsets(ell.starts, ell.widths)
    mask = ell.slots.nbr_mask
    per_pos = torch.cat([
        mask[o: o + (e - s) * w].view(e - s, w).sum(1)
        for o, s, e, w in zip(offs, ell.starts, ell.starts[1:],
                              ell.widths)])
    return per_pos[ell.inv_perm.long()].cpu().numpy().astype(np.int64)


def insert_edges(graph: DataGraph, new_edges,
                 new_edge_data: dict | None = None) -> DataGraph | None:
    """Land new undirected edges in reserved slack slots, no rebuild.

    Each new edge takes the next reserved edge row (ids ``n_edges``,
    ``n_edges + 1``, ...) and the next free slot of both endpoint rows:
    the slot order ``from_edges`` would have given them at the end of
    the input list, so stored id == input-order id for inserted edges.
    ``new_edge_data`` maps each edge field to ``[k, ...]`` rows written
    into the reserved edge rows (left zero when omitted).

    Returns a new ``DataGraph`` whose changed tensors are new ones (the
    input graph's tensors are never written), or ``None`` when an
    endpoint's row or the reserved edge rows are full: the caller then
    compacts with ``rebuild_compacted``.  Self-loop inserts raise.
    """
    ell = graph.ell
    if graph.slack <= 0:
        raise ValueError(
            "insert_edges needs mutable storage: build the graph with "
            "DataGraph.from_edges(slack=...) (DESIGN.md §13)")
    new_edges = np.asarray(new_edges, dtype=np.int64).reshape(-1, 2)
    k = len(new_edges)
    if k == 0:
        return graph
    if (new_edges[:, 0] == new_edges[:, 1]).any():
        raise ValueError("self-loop inserts are unsupported")
    if new_edges.min() < 0 or new_edges.max() >= graph.n_vertices:
        raise ValueError(
            f"edge endpoints must be in [0, {graph.n_vertices})")
    ne, cap = graph.n_edges, ell.pad_edge
    if ne + k > cap:
        return None
    dev = graph.device
    cnt = _row_slot_counts(ell)
    ends = np.unique(new_edges)
    pos = ell.inv_perm[torch.from_numpy(ends).to(dev)].cpu().numpy()
    starts = np.asarray(ell.starts, np.int64)
    b = np.searchsorted(starts[1:], pos, side="right")
    offs, _ = block_offsets(ell.starts, ell.widths)
    width = dict(zip(ends.tolist(),
                     np.asarray(ell.widths, np.int64)[b].tolist()))
    base = dict(zip(ends.tolist(), (np.asarray(offs, np.int64)[b]
                                    + (pos - starts[b])
                                    * np.asarray(ell.widths)[b]).tolist()))
    at, nbr, eid, src = [], [], [], []
    for i, (u, v) in enumerate(new_edges.tolist()):
        for r, other, is_src in ((u, v, True), (v, u, False)):
            if cnt[r] >= width[r]:
                return None        # the row is full: compact
            at.append(base[r] + int(cnt[r]))
            nbr.append(other)
            eid.append(ne + i)
            src.append(is_src)
            cnt[r] += 1
    idx = torch.tensor(at, dtype=torch.long, device=dev)
    put = lambda t, vals: t.index_put(
        (idx,), torch.tensor(vals, dtype=t.dtype, device=dev))
    slots = ell.slots
    new_ell = dataclasses.replace(ell, slots=EllRows(
        put(slots.nbrs, nbr), put(slots.nbr_mask, [True] * len(at)),
        put(slots.edge_ids, eid), put(slots.is_src, src)))
    ends_t = torch.from_numpy(new_edges.reshape(-1)).to(dev)
    degree = graph.degree.index_add(
        0, ends_t, torch.ones_like(ends_t, dtype=graph.degree.dtype))
    edge_data = graph.edge_data
    if new_edge_data is not None and edge_data:
        rows = torch.arange(ne, ne + k, device=dev)
        edge_data = {key: d.index_copy(0, rows, torch.as_tensor(
            np.asarray(new_edge_data[key])).to(dev, d.dtype))
            for key, d in edge_data.items()}
    fresh = np.arange(ne, ne + k, dtype=np.int64)
    return dataclasses.replace(
        graph, n_edges=ne + k, ell=new_ell, degree=degree,
        edge_data=edge_data,
        edges_np=np.concatenate([graph.edges_np, new_edges]),
        edge_perm=np.concatenate([graph.edge_perm, fresh]),
        edge_inv_perm=np.concatenate([graph.edge_inv_perm, fresh]))


def input_order_edges(graph: DataGraph) -> tuple[np.ndarray, dict]:
    """The *input-order* edge list (host) and edge data (tensors on the
    graph's device, without the reserved and pad rows).

    ``edge_perm[stored] = input`` inverts the bucket-major renumbering
    and any insert extensions, so feeding the result back through
    ``from_edges`` keeps every input-order edge id stable across a
    compaction.
    """
    ne = graph.n_edges
    edges_in = np.empty((ne, 2), dtype=np.int64)
    edges_in[graph.edge_perm] = graph.edges_np
    perm = torch.from_numpy(np.asarray(graph.edge_perm,
                                       np.int64)).to(graph.device)

    def back(a):
        out = torch.empty_like(a[:ne])
        out[perm] = a[:ne]
        return out

    return edges_in, {k: back(a) for k, a in graph.edge_data.items()}


def rebuild_compacted(graph: DataGraph, extra_edges=None,
                      extra_edge_data: dict | None = None,
                      slack: int | None = None,
                      edge_capacity: int | None = None) -> DataGraph:
    """Full compaction rebuild: the storage built again from the graph's
    input-order edges (plus pending inserts that no longer fit in its
    slack), carrying the current vertex and edge data and reserving
    fresh slack.  Input-order edge ids are kept; colors are not:
    callers owning a coloring color the result again."""
    edges_in, data_in = input_order_edges(graph)
    if extra_edges is not None and len(extra_edges):
        extra_edges = np.asarray(extra_edges, dtype=np.int64).reshape(-1, 2)
        kx = len(extra_edges)
        edges_in = np.concatenate([edges_in, extra_edges])
        data_in = {key: torch.cat([a, (
            a.new_zeros((kx,) + a.shape[1:]) if extra_edge_data is None
            else torch.as_tensor(np.asarray(extra_edge_data[key])).to(
                a.device, a.dtype))]) for key, a in data_in.items()}
    return DataGraph.from_edges(
        graph.n_vertices, edges_in, vertex_data=graph.vertex_data,
        edge_data=data_in, slack=graph.slack if slack is None else slack,
        edge_capacity=edge_capacity, device=graph.device)


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
