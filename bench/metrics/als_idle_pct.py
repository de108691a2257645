"""The device's idle share of one profiled ALS job, in percent
(``idle_pct``'s reading)."""

from bench import harness

read = harness.load_module(harness.HERE / "metrics" / "idle_pct.py").read
