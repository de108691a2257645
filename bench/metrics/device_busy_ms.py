"""Milliseconds a superstep in which an operation ran on the device, over
one profiled job (the union of its operations in the profiler's trace):
the device's own work, steadier than any host-clock time."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["busy_s"] or not prof["job_supersteps"]:
        return None
    return 1e3 * prof["busy_s"] / prof["job_supersteps"]
