"""Milliseconds an ALS sweep over the untraced window
(``superstep_ms``'s reading: its wall time over the supersteps of its
jobs; one superstep is a users' and a movies' phase)."""

from bench import harness

read = harness.load_module(harness.HERE / "metrics" / "superstep_ms.py").read
