"""The yardstick's peaks and the work a kernel's inputs need.

The peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity), at the
card's full 700 W power limit.  A kernel's least time is the larger of
the bytes its inputs need over the HBM rate and its operations over the
float32 rate; the bytes count each input byte read once and each output
byte written once, the way ``chip_smoke.py``'s ``bound_ms`` counts them
(frozen here from commit f7cd5cd), but from the benchmark's own edge
list and not from the port's padded storage.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
INDEX_BYTES = 4                # an int32 neighbour id
F32_BYTES = 4


def least_seconds(nbytes: float, flops: float) -> float:
    """The larger of the two times the card cannot beat."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def adjacency(ctx):
    """The benchmark's symmetric adjacency of a run's inputs (the
    configuration's adapter gives it), made once a run."""
    if "adjacency" not in ctx.cache:
        ctx.cache["adjacency"] = ctx.adapter.adjacency(
            ctx.torch, ctx.config, ctx.inputs, ctx.device)
    return ctx.cache["adjacency"]


def updated_mask(torch, n_vertices: int, ids, sel):
    """``[n_vertices]`` bool: the vertices a phase's batch updates
    (``ids[sel]``), without a host sync; padded batch slots repeat ids
    with ``sel`` False, so the scatter takes the maximum."""
    hit = torch.zeros(n_vertices, dtype=torch.int32, device=ids.device)
    hit.scatter_reduce_(0, ids.long(), sel.to(torch.int32), "amax")
    return hit > 0


def phase_counts(torch, adj, updated):
    """``(slots, rows_read, rows_out)`` of one phase as 0-d float64
    tensors: the edge slots of the updated vertices (their degrees'
    sum), the distinct vertices those slots read, and the updated
    vertices.  ``adj`` is the benchmark's symmetric adjacency: ``src``,
    ``dst`` (int64, one entry a direction of each edge) and ``deg``."""
    src, dst, deg = adj["src"], adj["dst"], adj["deg"]
    slots = (deg.to(torch.float64) * updated).sum()
    read = torch.zeros(updated.shape[0], dtype=torch.int32,
                       device=updated.device)
    read.scatter_reduce_(0, dst, updated[src].to(torch.int32), "amax")
    return slots, read.sum().to(torch.float64), updated.sum().to(
        torch.float64)


def spmv_work(slots, rows_read, rows_out, features: int = 1):
    """``(bytes, flops)`` of ``y[v] = sum_j w[v, j] x[nbr[v, j]]`` over a
    phase (B1, ``ell_spmv``): an id and a float32 weight a slot, each
    read row of x once, each updated row of y once; a multiply and an
    add a slot and feature."""
    nbytes = (slots * (INDEX_BYTES + F32_BYTES)
              + rows_read * features * F32_BYTES
              + rows_out * features * F32_BYTES)
    return nbytes, slots * 2 * features
