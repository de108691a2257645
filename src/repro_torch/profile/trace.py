"""Per-launch timing traces: the raw material the cost model fits.

The port of ``repro.profile.trace``: the same flat JSON records and
schema, so a trace from either package loads in the other.  Three
record kinds:

* ``launch`` — one timed ``apply_batch`` at a known shape:
  ``{"kind": "launch", "mode": "batch"|"bucket", "width": W,
  "rows": B, "wall_us": t, "cold": bool}``.  ``width * rows`` is the
  padded slot count the model regresses on.
* ``step`` — one engine superstep from ``api.run(profile=True)``: the
  same fields plus ``"phases"`` and, for bucket-mode steps, a
  ``"launches": [[W_b, rows_b], ...]`` composite instead of a single
  ``width``/``rows`` pair.  Only single-phase batch steps are fit points.
* ``sync`` — one timed row scatter: ``{"kind": "sync", "rows": H,
  "wall_us": t}``; fits the per-row ``sync_cost_us``.

The reference may nest XLA HLO op counts under an ``"hlo"`` key
(``hlo_counts``).  The port has no HLO to walk; its dry run nests the op
walker's counts there (``roofline.op_walk.Cost.counts``, which adds the
collectives' breakdown by kind), and its
launch records carry no ``"hlo"`` key unless a caller hands counts to
``record_launch``.

Artifacts go to ``results/torch/`` (or ``$REPRO_TORCH_RESULTS_DIR``),
never over the reference's ``results/TRACE_cpu.json``.
"""
from __future__ import annotations

import json
import os
import pathlib

from repro_torch.device import resolve_device

SCHEMA_VERSION = 1



def results_dir() -> pathlib.Path:
    """Artifact directory: ``$REPRO_TORCH_RESULTS_DIR`` or
    ``./results/torch``."""
    return pathlib.Path(os.environ.get("REPRO_TORCH_RESULTS_DIR",
                                       os.path.join("results", "torch")))


def hlo_counts(cost) -> dict:
    """Project a cost object (``flops`` / ``bytes`` / ``coll_bytes``
    attributes, and a ``coll_breakdown`` mapping if it has one) onto the
    shared trace schema's ``"hlo"`` dict."""
    d = {"flops": int(cost.flops), "hbm_bytes": int(cost.bytes),
         "coll_bytes": int(cost.coll_bytes)}
    br = getattr(cost, "coll_breakdown", None)
    if br:
        d["coll_breakdown"] = {k: int(v) for k, v in dict(br).items()}
    return d


class TraceRecorder:
    """Append-only launch/step/sync record sink with JSON persistence.
    ``device`` names the trace's device type; ``None`` is the GPU's
    (``resolve_device``: it raises without one)."""

    def __init__(self, device: str | None = None):
        if device is None:
            device = resolve_device(None).type
        self.device = device
        self.records: list[dict] = []

    def record_launch(self, *, mode: str, width: int, rows: int,
                      wall_us: float, cold: bool = False, hlo=None,
                      **extra) -> dict:
        rec = {"kind": "launch", "mode": mode, "width": int(width),
               "rows": int(rows), "wall_us": float(wall_us),
               "cold": bool(cold), **extra}
        if hlo is not None:
            rec["hlo"] = hlo_counts(hlo) if hasattr(hlo, "flops") else hlo
        self.records.append(rec)
        return rec

    def record_step(self, *, mode: str, wall_us: float, rows=None,
                    width=None, launches=None, phases: int = 1,
                    cold: bool = False, **extra) -> dict:
        rec = {"kind": "step", "mode": mode, "wall_us": float(wall_us),
               "phases": int(phases), "cold": bool(cold), **extra}
        if rows is not None:
            rec["rows"] = int(rows)
        if width is not None:
            rec["width"] = int(width)
        if launches is not None:
            rec["launches"] = [[int(w), int(r)] for w, r in launches]
        self.records.append(rec)
        return rec

    def record_sync(self, *, rows: int, wall_us: float,
                    cold: bool = False, **extra) -> dict:
        rec = {"kind": "sync", "rows": int(rows),
               "wall_us": float(wall_us), "cold": bool(cold), **extra}
        self.records.append(rec)
        return rec

    def to_json(self) -> dict:
        return {"schema": SCHEMA_VERSION, "device": self.device,
                "records": self.records}

    def save(self, path: str | os.PathLike | None = None) -> pathlib.Path:
        if path is None:
            path = results_dir() / f"TRACE_{self.device}.json"
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1))
        return path


def load_trace(path: str | os.PathLike) -> TraceRecorder:
    doc = json.loads(pathlib.Path(path).read_text())
    rec = TraceRecorder(device=doc.get("device", "unknown"))
    rec.records = list(doc.get("records", ()))
    return rec
