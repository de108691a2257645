"""B1 (``ell_spmv``) over one job: the least time its phases' work needs
(``roofline.spmv_work`` from the benchmark's own edge list) over the
device time between CUDA events around every call of its entry points,
in percent."""

from bench import roofline

# ``phase``: one conflict-free batch of an engine, ``apply_batch(struct,
# update_fn, carry, ids, valid, globals_, ...)``; the first call of a
# kernel entry inside it is charged the work of the vertices it updates
KERNEL = {
    "name": "ell_spmv",
    "entries": ["repro_torch.core.exec:ell_spmv_bucketed",
                "repro_torch.core.exec:ell_spmv_batched"],
    "phase": "repro_torch.core.exec:apply_batch",
    "counter": "repro_torch.kernels.ell_spmv:ell_spmv.launches",
    "trace_name": "ell_spmv",
}


def phase_batch(args, kwargs):
    """``(ids, sel)``: the batch a call of the phase updates, its tasks
    where ``valid & active[ids]`` (``carry[2]`` is the task set)."""
    carry, ids, valid = args[2], args[3], args[4]
    return ids, valid & carry[2][ids.long()]


def work(batch, ctx):
    ids, sel = batch
    adj = roofline.adjacency(ctx)
    counts = roofline.phase_counts(
        ctx.torch, adj,
        roofline.updated_mask(ctx.torch, adj["deg"].shape[0], ids, sel))
    return roofline.spmv_work(*counts,
                              features=ctx.inputs.get("features", 1))


def read(rec):
    k = rec.get("kernels", {}).get("ell_spmv")
    if not k or not k["calls"] or not k["device_s"]:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
