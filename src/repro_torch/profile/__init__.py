"""Trace-driven cost modelling: the port of ``repro.profile``.

``trace`` records per-launch wall times from the host stepping loop;
``model`` fits the per-bucket-width linear cost model
``t(W, B) ~= a_W + b_W * B * W`` that ``choose_dispatch`` and
``from_edges(width_policy="measured")`` consume; ``calibrate`` is the
CLI that bootstraps a model from microbenchmarks
(``python -m repro_torch.profile.calibrate``).

``tracing()`` opens the program's own spans and counters: inside it
the executor's layer boundaries (``job``, ``superstep``, ``phase``,
``select``, ``gather``, ``kernel``, ``update``, ``writeback``,
``reschedule``, ``syncs``) record host and device times and the
counters (``slots.*``, ``host_syncs``, ``launches.*``) their totals;
the yielded ``TraceRecorder`` holds them as ``span`` / ``count``
records, and its ``summary()`` sums them.  Outside it ``span`` and
``count`` are no-ops.

Only the light, numpy-only halves are re-exported here: importing
``repro_torch.profile`` pulls in neither the apps nor the kernels.
"""
from repro_torch.profile.model import (CostModel, fit_cost_model,  # noqa: F401
                                       load_cost_model, resolve_cost_model)
from repro_torch.profile.trace import (SCHEMA_VERSION,  # noqa: F401
                                       TraceRecorder, count, hlo_counts,
                                       load_trace, span, tracing)
