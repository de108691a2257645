"""Milliseconds a superstep over the untraced window: its wall time over
the supersteps of its jobs."""


def read(rec):
    if not rec["window_supersteps"]:
        return None
    return 1e3 * rec["window_seconds"] / rec["window_supersteps"]
