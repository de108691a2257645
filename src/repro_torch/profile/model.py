"""Fitted per-bucket-width launch cost model: the port of
``repro.profile.model``.

``fit_cost_model`` least-squares a line ``t(W, B) ~= a_W + b_W * B * W``
per distinct launch width over a trace's warm launch records, plus one
pooled line over all widths (the fallback for widths never measured)
and a per-row sync cost from the trace's ``sync`` records.  It is the
reference's numpy code, so the same records fit bitwise the same
coefficients in either package.

Fits are clamped so every predicted curve is monotone non-decreasing in
the padded slot count ``B * W`` for a fixed ``W``: a negative slope
collapses to the flat line through the sample mean.  So a noisy trace
can bias the batch/bucket crossover but never invert it arbitrarily.

``predict`` returns ``None`` (never a guess) for a shape the model has
no data for and no pooled fallback; every consumer treats ``None`` as
"use the static slot-count rule", which keeps a run with no trace
exactly what it was without a model.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.profile.trace import results_dir


def _fit_line(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """Least-squares ``y ~= a + b*x`` with ``b >= 0`` and ``a >= 0``.

    Under one distinct x (or a negative fitted slope) the fit collapses
    to the flat mean line — monotone by construction.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if len(np.unique(x)) < 2:
        return float(max(y.mean(), 0.0)), 0.0
    b, a = np.polyfit(x, y, 1)
    if b < 0:
        return float(max(y.mean(), 0.0)), 0.0
    a = max(float(a), 0.0)
    return a, float(b)


def _usable_fit_records(records) -> list[dict]:
    """Warm single-launch records: ``launch`` kind, or single-phase
    batch-mode ``step`` records (one launch, so the shape is known)."""
    out = []
    for r in records:
        if r.get("cold") or "width" not in r or "rows" not in r:
            continue
        if r.get("kind") == "launch":
            out.append(r)
        elif (r.get("kind") == "step" and r.get("mode") == "batch"
              and r.get("phases", 1) == 1):
            out.append(r)
    return out


@dataclasses.dataclass
class CostModel:
    """Predicted launch microseconds from (width, rows) shapes.

    ``coef[W] = (a_W, b_W)`` per measured width; ``pooled`` covers
    unmeasured widths; ``sync_cost_us`` prices one synced row.  An empty
    model predicts ``None`` everywhere.
    """
    device: str = "unknown"
    coef: dict = dataclasses.field(default_factory=dict)  # {W: (a, b)}
    pooled: tuple | None = None                           # (a, b)
    sync_cost_us: float = 0.0
    n_records: int = 0

    def predict(self, width: int, rows: int) -> float | None:
        """Predicted wall time (us) of one ``[rows, width]`` launch."""
        ab = self.coef.get(int(width), self.pooled)
        if ab is None:
            return None
        a, b = ab
        return a + b * float(rows) * float(width)

    def predict_launches(self, launches) -> float | None:
        """Predicted total for a ``[(W, rows), ...]`` launch sequence
        (e.g. ``SlicedEll.bucket_launches``); ``None`` if any launch
        is unpredictable."""
        total = 0.0
        for w, rows in launches:
            t = self.predict(w, rows)
            if t is None:
                return None
            total += t
        return total

    def to_json(self) -> dict:
        return {"schema": 1, "device": self.device,
                "coef": {str(w): list(ab) for w, ab in
                         sorted(self.coef.items())},
                "pooled": list(self.pooled) if self.pooled else None,
                "sync_cost_us": self.sync_cost_us,
                "n_records": self.n_records}

    def save(self, path: str | os.PathLike | None = None) -> pathlib.Path:
        if path is None:
            path = results_dir() / f"COSTMODEL_{self.device}.json"
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1))
        return path

    @classmethod
    def load(cls, path: str | os.PathLike) -> "CostModel":
        doc = json.loads(pathlib.Path(path).read_text())
        return cls(device=doc.get("device", "unknown"),
                   coef={int(w): tuple(ab)
                         for w, ab in doc.get("coef", {}).items()},
                   pooled=tuple(doc["pooled"]) if doc.get("pooled") else None,
                   sync_cost_us=float(doc.get("sync_cost_us", 0.0)),
                   n_records=int(doc.get("n_records", 0)))


def fit_cost_model(records, device: str = "unknown") -> CostModel:
    """Fit a :class:`CostModel` from trace records (see module doc)."""
    usable = _usable_fit_records(records)
    coef: dict[int, tuple[float, float]] = {}
    xs_all, ys_all = [], []
    by_width: dict[int, list[dict]] = {}
    for r in usable:
        by_width.setdefault(int(r["width"]), []).append(r)
    for w, rs in by_width.items():
        x = np.array([float(r["rows"]) * w for r in rs])
        y = np.array([r["wall_us"] for r in rs])
        coef[w] = _fit_line(x, y)
        xs_all.append(x)
        ys_all.append(y)
    pooled = None
    if xs_all:
        pooled = _fit_line(np.concatenate(xs_all), np.concatenate(ys_all))
    syncs = [r for r in records
             if r.get("kind") == "sync" and not r.get("cold")
             and r.get("rows")]
    sync_cost = 0.0
    if syncs:
        # per-row slope, clamped >= 0; one sample degrades to wall/rows
        x = np.array([float(r["rows"]) for r in syncs])
        y = np.array([r["wall_us"] for r in syncs])
        if len(np.unique(x)) >= 2:
            b = np.polyfit(x, y, 1)[0]
            sync_cost = float(max(b, 0.0))
        else:
            sync_cost = float(max((y / x).mean(), 0.0))
    return CostModel(device=device, coef=coef, pooled=pooled,
                     sync_cost_us=sync_cost, n_records=len(usable))


def default_device() -> str:
    """The device type a model is loaded for by default: the GPU's
    (``resolve_device``: it raises without one)."""
    return resolve_device(None).type


def load_cost_model(device: str | None = None,
                    path: str | os.PathLike | None = None
                    ) -> CostModel | None:
    """Load ``results/torch/COSTMODEL_<device>.json`` if one exists;
    ``device`` is a device type (``"cuda"``, ``"cpu"``), default the
    GPU's."""
    if path is None:
        if device is None:
            device = default_device()
        path = results_dir() / f"COSTMODEL_{device}.json"
    path = pathlib.Path(path)
    if not path.exists():
        return None
    return CostModel.load(path)


#: Entry-point group out-of-tree cost models register under
#: (``core/registry.py`` plugin discovery).
COST_MODEL_PLUGIN_GROUP = "repro_torch.cost_models"


def resolve_cost_model(spec, device: str | None = None) -> CostModel | None:
    """Normalize a ``cost_model=`` argument to a model instance or None.

    Accepts: ``None`` / ``"static"`` (no model — the static dispatch
    rule), a :class:`CostModel` (or any object with ``predict`` /
    ``predict_launches``), ``"measured"`` (the persisted calibration of
    ``device``, a device type defaulting to the GPU's), a path to a
    ``COSTMODEL_*.json``, or the name of a ``repro_torch.cost_models``
    entry point.
    """
    if spec is None or spec == "static":
        return None
    if hasattr(spec, "predict") and hasattr(spec, "predict_launches"):
        return spec
    if not isinstance(spec, str):
        raise ValueError(
            f"cost_model must be None, 'static', 'measured', a CostModel, "
            f"a COSTMODEL_*.json path, or a {COST_MODEL_PLUGIN_GROUP!r} "
            f"entry-point name; got {spec!r}")
    if spec == "measured":
        model = load_cost_model(device)
        if model is None:
            raise ValueError(
                "cost_model='measured' but no "
                f"{results_dir()}/COSTMODEL_*.json exists for this device; "
                "record one with `python -m repro_torch.profile.calibrate` "
                "or api.run(..., profile=True)")
        return model
    p = pathlib.Path(spec)
    if p.suffix == ".json" or p.exists():
        return CostModel.load(p)
    from repro_torch.core.registry import load_plugin
    plugin = load_plugin(COST_MODEL_PLUGIN_GROUP, spec)
    if plugin is not None:
        model = plugin() if callable(plugin) else plugin
        return resolve_cost_model(model, device)
    raise ValueError(
        f"unknown cost_model {spec!r}: not 'static'/'measured', not an "
        f"existing model file, and no {COST_MODEL_PLUGIN_GROUP!r} "
        f"entry point provides it")
