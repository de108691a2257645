"""Milliseconds an ALS sweep in which an operation ran on the device,
over one profiled job (``device_busy_ms``'s reading)."""

from bench import harness

read = harness.load_module(harness.HERE / "metrics"
                           / "device_busy_ms.py").read
