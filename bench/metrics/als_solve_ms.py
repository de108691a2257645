"""Milliseconds an ALS sweep in the vertex solve: the ridge, the batched
LU solve of ``d x d`` systems and the prediction
(``repro_torch.apps.als:ridge_solve``, once a group), bracketed by
synchronizes over one job."""

SPANS = {"solve": ["repro_torch.apps.als:ridge_solve"]}


def read(rec):
    spans = rec.get("spans")
    if not spans or not spans["job_supersteps"]:
        return None
    return 1e3 * spans["by_label"]["solve"] / spans["job_supersteps"]
