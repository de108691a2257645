"""Milliseconds an ALS sweep in the write-back, the reschedule and the
sync refresh (``reschedule_ms``'s entries and reading: on the
color-major plan one ``scatter_result`` and one
``consume_and_reschedule`` a phase), bracketed by synchronizes over one
job."""

from bench import harness

_reschedule = harness.load_module(harness.HERE / "metrics"
                                  / "reschedule_ms.py")
SPANS = _reschedule.SPANS
read = _reschedule.read
