"""Milliseconds an ALS sweep in the scope gather (``gather_ms``'s
entries and reading: on the color-major plan, ``gather_scopes`` once a
group), bracketed by synchronizes over one job."""

from bench import harness

_gather = harness.load_module(harness.HERE / "metrics" / "gather_ms.py")
SPANS = _gather.SPANS
read = _gather.read
