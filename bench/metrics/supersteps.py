"""Supersteps of a job (``RunResult.superstep`` of the window's last)."""


def read(rec):
    return rec["last_job_supersteps"]
