"""Milliseconds an ALS sweep in B3, the normal equations of the gathered
scopes (``repro_torch.apps.als:als_normal_eq_fold``, once a group),
bracketed by synchronizes over one job."""

SPANS = {"fold": ["repro_torch.apps.als:als_normal_eq_fold"]}


def read(rec):
    spans = rec.get("spans")
    if not spans or not spans["job_supersteps"]:
        return None
    return 1e3 * spans["by_label"]["fold"] / spans["job_supersteps"]
