"""Checkpointing: flat-path npz snapshots of trees of tensors.

The port of ``repro.train.checkpoint``, file for file: the same keys
(dict keys and sequence indices joined by ``::``), the same dtypes, the
same guards and messages, so a file either package writes, the other
reads.  Also the paper's §8 sketch, "a globally consistent snapshot
mechanism can be easily performed using the Sync operation": the graph
engines are superstep-synchronous, so an ``EngineState`` between
supersteps IS the consistent snapshot (``snapshot_engine_state``).

Writes are atomic (tmp file + ``os.replace``): a kill mid-save leaves
the previous checkpoint or none, never a truncated archive.  ``restore``
raises :class:`CheckpointError`, naming the missing key, the mismatched
shape or the corrupt archive.  Sharded snapshots of the distributed
engines live in ``repro_torch.ft.snapshot``, on the same conventions.

Tensors leave for the host with ``.cpu()`` and are written before the
call returns, so nothing a later superstep makes can reach a file.
bfloat16 and float8 tensors are stored as float32 and cast back on
restore; the engine's update counter (int64 in the port, int32 in the
reference) is stored as int32 and refused if it does not fit.
"""
from __future__ import annotations

import os
import zipfile
from typing import Any

import numpy as np
import torch

PyTree = Any
_SEP = "::"
_RECAST = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)

# Bump when the set of keys snapshot_engine_state writes (or their
# meaning) changes; restore_engine_state refuses other versions.
ENGINE_SNAPSHOT_SCHEMA = 2


class CheckpointError(Exception):
    """A checkpoint could not be read back: missing file, corrupt
    archive, missing key, shape mismatch, or schema mismatch."""


def flat_items(tree: PyTree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(key, leaf)`` of a tree of dicts, lists and tuples: dict keys
    (sorted, as JAX flattens them) and sequence indices joined by
    ``::``, the reference's key strings."""
    def join(k):
        return f"{prefix}{_SEP}{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flat_items(tree[k],
                                                               join(k))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flat_items(v, join(i))]
    return [(prefix, tree)]


def map_with_keys(fn, tree: PyTree, prefix: str = "") -> PyTree:
    """``fn(key, leaf)`` over ``tree``, keeping its structure."""
    def join(k):
        return f"{prefix}{_SEP}{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: map_with_keys(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_keys(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def to_host(leaf) -> np.ndarray:
    """A leaf as the numpy array a file holds (bfloat16 and float8 as
    float32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in _RECAST:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def int32_counter(arr, name: str) -> np.ndarray:
    """An update / traffic counter as int32, as the reference stores it;
    a count past int32 raises instead of wrapping."""
    arr = np.asarray(arr)
    if arr.size and (arr.max() > np.iinfo(np.int32).max
                     or arr.min() < np.iinfo(np.int32).min):
        raise CheckpointError(
            f"counter {name!r} ({int(arr.max())}) does not fit the "
            "snapshot's int32")
    return arr.astype(np.int32)


def from_host(arr: np.ndarray, like) -> Any:
    """A stored array in the dtype and on the device of ``like`` (a
    tensor, or a Python scalar)."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(like.device, like.dtype)
    return type(like)(np.asarray(arr).item())


def _flatten(tree: PyTree) -> dict:
    return {k: to_host(v) for k, v in flat_items(tree)}


def _atomic_savez(path: str, flat: dict) -> None:
    """np.savez to ``path`` such that ``path`` is never truncated: the
    archive is built under a tmp name and published with os.replace."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save(path: str, tree: PyTree, step: int | None = None) -> None:
    flat = _flatten(tree)
    if step is not None:
        flat["__step__"] = np.asarray(step)
    _atomic_savez(path, flat)


def _load_npz(path: str):
    path = path if path.endswith(".npz") else path + ".npz"
    if not os.path.exists(path):
        raise CheckpointError(f"checkpoint not found: {path}")
    try:
        data = np.load(path)
        data.files  # forces the zip directory read
        return data
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise CheckpointError(
            f"corrupt checkpoint archive {path}: {e}") from e


def restore(path: str, like: PyTree) -> tuple[PyTree, int | None]:
    """Restore into the structure of ``like`` (dtypes and devices
    preserved)."""
    data = _load_npz(path)

    def load(key, leaf):
        if key not in data:
            raise CheckpointError(
                f"checkpoint {path} is missing key {key!r}; "
                f"it has {sorted(data.files)[:8]}...")
        raw = data[key]
        want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
        if tuple(raw.shape) != want:
            raise CheckpointError(
                f"checkpoint {path} key {key!r} has shape "
                f"{tuple(raw.shape)}, expected {want}")
        return from_host(raw, leaf)

    tree = map_with_keys(load, like)
    step = int(data["__step__"]) if "__step__" in data else None
    return tree, step


def _state_tree(state) -> dict:
    return {"vertex_data": state.vertex_data, "edge_data": state.edge_data,
            "active": state.active, "priority": state.priority,
            "globals": state.globals, "n_updates": state.n_updates}


def snapshot_engine_state(path: str, state) -> None:
    """Consistent snapshot of an engine's ``EngineState`` between
    supersteps (the paper's §8 Sync-based snapshot).

    Saves what a bitwise resume needs: data, the task set, priorities,
    sync results and the update counter; the superstep goes into
    ``__step__``.  The file is stamped with a schema version and the
    EngineState field set, so a restore against another layout fails
    by name.  ``restore_engine_state`` is the inverse."""
    from repro_torch.core.exec import engine_state_field_names
    flat = _flatten(_state_tree(state))
    flat["n_updates"] = int32_counter(flat["n_updates"], "n_updates")
    flat["__step__"] = np.asarray(int(state.superstep))
    flat["__schema__"] = np.asarray(ENGINE_SNAPSHOT_SCHEMA)
    flat["__fields__"] = np.asarray(",".join(engine_state_field_names()))
    _atomic_savez(path, flat)


def restore_engine_state(path: str, like):
    """Restore a ``snapshot_engine_state`` file into an EngineState
    shaped like ``like`` (e.g. ``engine.init_state()``): its dtypes, on
    its device.  Superstep boundaries are globally consistent cuts, so
    ``engine.resume(restore_engine_state(path, engine.init_state()))``
    continues bitwise the run that never stopped."""
    import dataclasses

    from repro_torch.core.exec import engine_state_field_names
    data = _load_npz(path)
    if "__schema__" not in data:
        raise CheckpointError(
            f"{path} is not a versioned engine snapshot (no __schema__ "
            f"field); re-save it with snapshot_engine_state")
    schema = int(data["__schema__"])
    if schema != ENGINE_SNAPSHOT_SCHEMA:
        raise CheckpointError(
            f"{path} has engine-snapshot schema {schema}, this build "
            f"reads {ENGINE_SNAPSHOT_SCHEMA}")
    saved_fields = str(data["__fields__"]) if "__fields__" in data else ""
    want_fields = ",".join(engine_state_field_names())
    if saved_fields != want_fields:
        missing = set(want_fields.split(",")) - set(saved_fields.split(","))
        extra = set(saved_fields.split(",")) - set(want_fields.split(","))
        raise CheckpointError(
            f"{path} EngineState field set mismatch: snapshot has "
            f"[{saved_fields}], this build has [{want_fields}]"
            + (f"; missing {sorted(missing)}" if missing else "")
            + (f"; unknown {sorted(extra)}" if extra else ""))
    restored, step = restore(path, _state_tree(like))
    return dataclasses.replace(like, **restored,
                               superstep=step if step is not None else 0)
