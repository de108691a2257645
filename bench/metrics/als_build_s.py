"""Seconds of the ALS adapter's build (``build_s``'s reading): the
rating graph's storage and coloring, its sorts on the card, the copy to
it."""

from bench import harness

read = harness.load_module(harness.HERE / "metrics" / "build_s.py").read
