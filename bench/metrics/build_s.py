"""Seconds of the adapter's build: the port's storage, weights and
coloring on the host, and the copy to the card."""


def read(rec):
    return rec["build_seconds"]
