"""The device's idle share of one profiled job, in percent: one less the
union of its operations in the profiler's trace over the job's wall."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
