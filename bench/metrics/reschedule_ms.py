"""Milliseconds a superstep in the write-back, the reschedule and the
sync refresh, bracketed by synchronizes over one job."""

SPANS = {"reschedule": [
    "repro_torch.core.exec:scatter_result",
    "repro_torch.core.exec:consume_and_reschedule",
    "repro_torch.core.exec:refresh_syncs",
]}


def read(rec):
    spans = rec.get("spans")
    if not spans or not spans["job_supersteps"]:
        return None
    return 1e3 * spans["by_label"]["reschedule"] / spans["job_supersteps"]
