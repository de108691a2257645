"""B3 (``als_normal_eq``) over one ALS job: the least time its phases'
work needs over the device time between CUDA events around every call
of the ALS update's fold, in percent.

A phase's work is counted from the benchmark's own triples, for the
vertices the phase updates.  A vertex of degree k reads k rows of its
neighbours' d float32 factors, k ratings and k mask bytes, and writes
its A (d x d) and b (d): ``k (4d + 4 + 1) + 4 (d^2 + d)`` bytes.  A is
symmetric, so the kernel builds its upper triangle and b, a multiply and
an add each: ``k (d (d + 1) + 2d)`` flops.
"""

from bench import roofline

# ``phase``: one conflict-free batch of an engine, ``apply_batch(struct,
# update_fn, carry, ids, valid, globals_, ...)``; the first fold inside
# it is charged the work of the vertices it updates
KERNEL = {
    "name": "als_normal_eq",
    "entries": ["repro_torch.apps.als:als_normal_eq_fold"],
    "phase": "repro_torch.core.exec:apply_batch",
    "counter": "repro_torch.kernels.als_normal_eq:als_normal_eq.launches",
    "trace_name": "als_normal_eq",
}


def phase_batch(args, kwargs):
    """``(ids, sel)``: the batch a call of the phase updates, its tasks
    where ``valid & active[ids]`` (``carry[2]`` is the task set)."""
    carry, ids, valid = args[2], args[3], args[4]
    return ids, valid & carry[2][ids.long()]


def normal_eq_work(slots, rows_out, d: int):
    """``(bytes, flops)`` of the normal equations of ``rows_out`` vertices
    whose degrees add up to ``slots``, at factor width ``d``."""
    nbytes = slots * (4 * d + 4 + 1) + rows_out * 4 * (d * d + d)
    return nbytes, slots * (d * (d + 1) + 2 * d)


def work(batch, ctx):
    ids, sel = batch
    torch = ctx.torch
    deg = roofline.adjacency(ctx)["deg"]
    upd = roofline.updated_mask(torch, deg.shape[0], ids, sel)
    return normal_eq_work((deg.to(torch.float64) * upd).sum(),
                          upd.sum().to(torch.float64), ctx.config["d"])


def read(rec):
    k = rec.get("kernels", {}).get("als_normal_eq")
    if not k or not k["calls"] or not k["device_s"]:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
