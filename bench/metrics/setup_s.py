"""Seconds from the process's start to the first timed job: data made
from the seed, the port's build, the kernels loaded, one warm job."""


def read(rec):
    return rec["setup_seconds"]
