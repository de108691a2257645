"""Milliseconds a superstep in the scope gather and the routing onto
the degree buckets, bracketed by synchronizes over one job."""

SPANS = {"gather": [
    "repro_torch.core.exec:gather_scopes",
    "repro_torch.core.exec:route_batch_to_buckets",
    "repro_torch.core.exec:_owner_rows",
    "repro_torch.core.graph:SlicedEll.rows",
    "repro_torch.core.graph:SlicedEll.row_activation",
]}


def read(rec):
    spans = rec.get("spans")
    if not spans or not spans["job_supersteps"]:
        return None
    return 1e3 * spans["by_label"]["gather"] / spans["job_supersteps"]
