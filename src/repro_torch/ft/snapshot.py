"""Sharded consistent snapshots of a distributed engine's carry.

The port of ``repro.ft.snapshot``.  The distributed engines are
superstep-synchronous: between supersteps every shard has applied the
same prefix of work and the ghost exchange for that prefix has
completed, so a cut at a superstep boundary is a globally consistent
snapshot (paper §8; DESIGN.md §12).  A snapshot is one directory per
boundary, in the reference's layout, so either package reads what the
other wrote::

    <ckpt_dir>/step_00000012/
        shard_00000.npz ... shard_{M-1:05d}.npz   # per-shard carry rows
        host.npz                                  # globals, superstep,
                                                  # partition assignment
        MANIFEST.json                             # written LAST

Keys are the carry's paths joined with ``::`` (``vertex_data::rank``,
``globals::top2::0``); ``globals`` and ``superstep`` go to ``host.npz``,
everything else is cut per shard.  The manifest carries a schema
version, the shard count, the scheduler, the partition fingerprint, each
key's dtype and ``[M, ...]`` shape and a sha256 digest of every file.
It is written last inside a hidden tmp directory published with one
``os.replace``, so a torn write (a kill, or an injected
``checkpoint_fail``) leaves the previous snapshot or an unpublished tmp
directory, never a half snapshot.  Every failure at load is a
:class:`SnapshotError` naming what was wrong; ``latest_valid_snapshot``
skips damaged directories.

The carry layouts differ and the files do not: the port keeps a list
with one entry a local shard where the reference stacks ``[M, ...]``,
one ``globals`` a shard, a Python ``superstep`` and int64 counters
(``n_updates``, ``ghost_sent``, ``ghost_full``).  The files hold the
reference's layout and dtypes: int32 counters (a count past int32
raises), a 0-d int32 ``superstep``, bfloat16 / float8 as float32 with
the manifest naming the original dtype.

Under a ``ProcessGroupMesh`` each rank holds its own shard: each writes
its own ``shard_*.npz``; after a barrier, once every shard's digest is
gathered, rank 0 writes ``host.npz`` and the manifest and publishes the
directory.  A load reads ``host.npz`` and the rank's own shard files.

What must be saved is the whole carry: owned and ghost rows, the task
set and priorities, sync globals and, for the locking engine, the ghost
version counters (``version`` / ``eversion`` / ``sent_ver`` /
``esent_ver``): without them a resumed run would ship other rows.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from glob import glob

import numpy as np
import torch

from repro_torch.core.mesh import ProcessGroupMesh
from repro_torch.train.checkpoint import (_RECAST, flat_items, from_host,
                                          int32_counter, map_with_keys,
                                          to_host)

SCHEMA = 1
# carry keys replicated across shards (everything else is per shard)
_REPLICATED = ("globals", "superstep")
# the engines' counters: int64 tensors in the port, int32 in the files
_COUNTERS = ("n_updates", "ghost_sent", "ghost_full")


class SnapshotError(Exception):
    """A sharded snapshot could not be written or read back: torn
    directory, digest mismatch, schema/partition/shard-count mismatch,
    or missing/mis-shaped keys."""


def _layout(carry: dict, mesh) -> tuple[int, tuple[int, ...]]:
    """``(M, the global ids of the carry's local shards)``."""
    if mesh is not None:
        return mesh.n_shards, tuple(mesh.shards)
    m = len(carry["n_updates"])
    return m, tuple(range(m))


def _group(mesh) -> ProcessGroupMesh | None:
    return mesh if isinstance(mesh, ProcessGroupMesh) else None


def _barrier(pg) -> None:
    if pg is not None:
        import torch.distributed as dist
        dist.barrier(group=pg.group)


def _all_ranks(pg, ok: bool) -> bool:
    """``ok`` on every rank (one ``psum``), so ranks agree."""
    if pg is None:
        return ok
    flag = torch.tensor([int(ok)], device=pg.device(pg.rank))
    return int(pg.psum([flag])[0].item()) == pg.n_shards


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_npz(path: str, arrays: dict) -> None:
    with open(path, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype in _RECAST:
        return str(leaf.dtype).split(".")[-1]
    return to_host(leaf).dtype.name


def _file_array(key: str, leaf) -> np.ndarray:
    arr = to_host(leaf)
    return int32_counter(arr, key) if key in _COUNTERS else arr


def _shard_items(carry: dict, k: int) -> list:
    """``(key, leaf)`` of local shard ``k``'s per-shard carry entries."""
    return [kv for name in sorted(carry) if name not in _REPLICATED
            for kv in flat_items(carry[name][k], name)]


def _host_items(carry: dict) -> list:
    return (flat_items(carry["globals"][0], "globals")
            + [("superstep", carry["superstep"])])


def write_snapshot(ckpt_dir: str, carry: dict, *, scheduler: str,
                   partition: str, assignment: np.ndarray,
                   faults=None, mesh=None) -> str:
    """Write one snapshot of ``carry`` (the port's layout: a list entry
    a local shard) under ``ckpt_dir``; returns the published ``step_*``
    directory.

    ``partition`` is ``ShardPlan.partition_fingerprint``; ``assignment``
    the ``[Nv]`` shard assignment, saved so a resume can rebuild the
    same plan.  ``faults`` (a ``FaultPlan``) gets a ``checkpoint_write``
    firing before every shard file: an injected failure leaves the tmp
    directory torn and the previous snapshot untouched.  ``mesh`` is
    the engine's mesh: under a ``ProcessGroupMesh`` each rank writes its
    own shard and rank 0 the rest (every rank must call this).
    """
    n_shards, shards = _layout(carry, mesh)
    pg = _group(mesh)
    lead = pg is None or pg.rank == 0
    step = int(carry["superstep"])
    fields = {k: {"dtype": _dtype_name(v), "shape": list(
        _file_array(k, v).shape)} for k, v in _host_items(carry)}
    fields["superstep"]["dtype"] = "int32"
    for k, v in _shard_items(carry, 0):
        fields[k] = {"dtype": ("int32" if k in _COUNTERS
                               else _dtype_name(v)),
                     "shape": [n_shards] + list(to_host(v).shape)}

    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}")
    if lead:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _barrier(pg)

    digests = {}
    for k, s in enumerate(shards):
        if faults is not None:
            faults.fire("checkpoint_write", superstep=step, shard=s)
        name = f"shard_{s:05d}.npz"
        _write_npz(os.path.join(tmp, name),
                   {key: _file_array(key, v)
                    for key, v in _shard_items(carry, k)})
        digests[name] = _sha256(os.path.join(tmp, name))
    if pg is not None:
        import torch.distributed as dist
        every = [None] * pg.n_shards
        dist.all_gather_object(every, digests, group=pg.group)
        digests = {n: d for part in every for n, d in part.items()}
    if lead:
        host = {k: _file_array(k, v) for k, v in _host_items(carry)}
        host["superstep"] = np.asarray(step, np.int32)
        host["__assignment__"] = np.asarray(assignment, dtype=np.int64)
        _write_npz(os.path.join(tmp, "host.npz"), host)
        digests["host.npz"] = _sha256(os.path.join(tmp, "host.npz"))
        manifest = {"schema": SCHEMA, "superstep": step,
                    "n_shards": n_shards, "scheduler": scheduler,
                    "partition": partition, "fields": fields,
                    "files": dict(sorted(digests.items()))}
        mpath = os.path.join(tmp, "MANIFEST.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
    _barrier(pg)
    return final


def read_manifest(path: str) -> dict:
    mpath = os.path.join(path, "MANIFEST.json")
    if not os.path.exists(mpath):
        raise SnapshotError(f"{path}: no MANIFEST.json (torn or not a "
                            "snapshot directory)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise SnapshotError(f"{path}: unreadable manifest: {e}") from e
    if manifest.get("schema") != SCHEMA:
        raise SnapshotError(
            f"{path}: snapshot schema {manifest.get('schema')!r}, this "
            f"build reads {SCHEMA}")
    return manifest


def validate_snapshot(path: str, *, expect_partition: str | None = None,
                      expect_scheduler: str | None = None,
                      expect_n_shards: int | None = None,
                      shards=None) -> dict:
    """Integrity and identity check; returns the manifest.

    Digest-checks the files the manifest names (``host.npz`` and the
    shard files of ``shards`` only, when given: a rank's own), then the
    snapshot's identity against the expectations: a snapshot taken on
    another partition (local row spaces would silently misalign),
    scheduler (another carry layout) or shard count is refused here, not
    discovered as wrong numbers after resume.
    """
    manifest = read_manifest(path)
    mine = (None if shards is None
            else {"host.npz"} | {f"shard_{s:05d}.npz" for s in shards})
    for name, digest in manifest["files"].items():
        if mine is not None and name not in mine:
            continue
        fpath = os.path.join(path, name)
        if not os.path.exists(fpath):
            raise SnapshotError(f"{path}: missing file {name}")
        actual = _sha256(fpath)
        if actual != digest:
            raise SnapshotError(
                f"{path}: digest mismatch for {name} (manifest "
                f"{digest[:12]}…, file {actual[:12]}… — torn or "
                "corrupted write)")
    if (expect_partition is not None
            and manifest["partition"] != expect_partition):
        raise SnapshotError(
            f"{path}: partition fingerprint {manifest['partition']} "
            f"does not match this run's plan ({expect_partition}); "
            "rebuild the plan from the snapshot's stored assignment")
    if (expect_scheduler is not None
            and manifest["scheduler"] != expect_scheduler):
        raise SnapshotError(
            f"{path}: snapshot was taken by scheduler "
            f"{manifest['scheduler']!r}, this run is "
            f"{expect_scheduler!r}")
    if (expect_n_shards is not None
            and manifest["n_shards"] != expect_n_shards):
        raise SnapshotError(
            f"{path}: snapshot has {manifest['n_shards']} shards, this "
            f"run has {expect_n_shards}")
    return manifest


def read_assignment(path: str, shards=None) -> tuple[np.ndarray, dict]:
    """The stored ``[Nv]`` shard assignment and the manifest: what
    ``api.run(resume_from=...)`` needs to rebuild the ShardPlan."""
    manifest = validate_snapshot(path, shards=shards)
    host = np.load(os.path.join(path, "host.npz"))
    if "__assignment__" not in host:
        raise SnapshotError(f"{path}: host.npz has no __assignment__")
    return host["__assignment__"], manifest


def load_carry(path: str, like_carry: dict, *,
               expect_partition: str | None = None,
               expect_scheduler: str | None = None,
               mesh=None) -> tuple[dict, int]:
    """Validate and load a snapshot into the structure, dtypes and
    devices of ``like_carry`` (``engine.init_carry()``); returns
    ``(carry, superstep)``.  Only the local shards are read (``mesh``'s,
    or all of them); bfloat16 / float8 leaves, stored as float32, and
    the int32 counters are cast back to ``like_carry``'s dtypes."""
    n_shards, shards = _layout(like_carry, mesh)
    manifest = validate_snapshot(
        path, expect_partition=expect_partition,
        expect_scheduler=expect_scheduler, expect_n_shards=n_shards,
        shards=shards if _group(mesh) is not None else None)
    fields = manifest["fields"]
    host = np.load(os.path.join(path, "host.npz"))

    def field(key, got, want):
        if key not in fields:
            raise SnapshotError(
                f"{path}: snapshot has no key {key!r}; it has "
                f"{sorted(fields)[:8]}… (engine carry layout changed?)")
        if tuple(got) != tuple(want):
            raise SnapshotError(
                f"{path}: key {key!r} has shape {tuple(got)}, this plan "
                f"expects {tuple(want)}")

    def replicated(key, leaf):
        want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
        field(key, fields.get(key, {}).get("shape", ()), want)
        return from_host(host[key], leaf)

    out = {}
    for k, s in enumerate(shards):
        with np.load(os.path.join(path, f"shard_{s:05d}.npz")) as sh:
            def per_shard(key, leaf):
                want = (n_shards,) + tuple(leaf.shape)
                field(key, fields.get(key, {}).get("shape", ()), want)
                return from_host(sh[key], leaf)
            for name in like_carry:
                if name in _REPLICATED:
                    continue
                out.setdefault(name, []).append(
                    map_with_keys(per_shard, like_carry[name][k], name))
    out["globals"] = [map_with_keys(replicated, g, "globals")
                      for g in like_carry["globals"]]
    field("superstep", fields.get("superstep", {}).get("shape", ()), ())
    out["superstep"] = int(host["superstep"])
    return out, manifest["superstep"]


def latest_valid_snapshot(ckpt_dir: str, *,
                          expect_partition: str | None = None,
                          expect_scheduler: str | None = None,
                          expect_n_shards: int | None = None,
                          mesh=None) -> str | None:
    """Newest ``step_*`` directory under ``ckpt_dir`` that passes
    ``validate_snapshot``; damaged or mismatched ones are skipped (what
    makes an injected checkpoint-write failure recoverable: the torn
    attempt never published, the previous snapshot wins).  Under a
    ``ProcessGroupMesh`` each rank checks its own files and the ranks
    agree on the newest snapshot valid on all of them."""
    pg = _group(mesh)
    for path in sorted(glob(os.path.join(ckpt_dir, "step_*")),
                       reverse=True):
        try:
            validate_snapshot(path, expect_partition=expect_partition,
                              expect_scheduler=expect_scheduler,
                              expect_n_shards=expect_n_shards,
                              shards=None if pg is None else mesh.shards)
            ok = True
        except SnapshotError:
            ok = False
        if _all_ranks(pg, ok):
            return path
    return None
