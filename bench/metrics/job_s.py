"""The window's wall time over the whole jobs finished in it: the time
to a converged answer."""


def read(rec):
    return rec["window_seconds"] / rec["jobs"]
