"""The port's fault tolerance (``repro_torch.ft``, ``train.checkpoint``,
``api.run``'s five fault-tolerance options) against the reference's.

* Twins of every in-process test of ``tests/test_ft.py`` and of the
  engine-snapshot tests of ``tests/test_optim_ckpt.py``: each faulted
  run bitwise the port's unfaulted run, its restart log (error types,
  messages, backoffs, restored supersteps) the reference's, error
  messages the reference's.
* Interchange, both directions, both snapshot kinds, on CC (bitwise
  across the packages; PageRank is not, fault C2): a snapshot the
  reference wrote mid-run is resumed by the port and finishes bitwise
  the reference's uninterrupted run, and the other way round.  The
  sharded kind at M = 8 runs the reference in one module-scoped
  subprocess on 8 virtual devices; the single-device ``state_step_*``
  kind runs both packages in this process.
* The reference's 8-shard acceptance matrix (checkpoint_fail@4, kill@6,
  transient@9, chromatic and locking) on the port's ``LocalMesh``.
* Two gloo ranks of ``ProcessGroupMesh``: each rank writes only its own
  shard files, and the killed, resumed run is bitwise the ``LocalMesh``
  run.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

from conftest import random_graph
from repro import api as ref_api
from repro.apps import cc as ref_cc
from repro.apps import pagerank as ref_pagerank
from repro.ft import FaultEvent as RefFaultEvent
from repro.ft import FaultPlan as RefFaultPlan
from repro.train import checkpoint as ref_ckpt
from repro_torch import api
from repro_torch.apps import cc, pagerank
from repro_torch.core.engine_chromatic import ChromaticEngine
from repro_torch.core.engine_locking import LockingEngine
from repro_torch.core.mesh import LocalMesh
from repro_torch.core.partition import two_phase_partition
from repro_torch.ft import (CheckpointWriteFault, FaultEvent, FaultPlan,
                            SnapshotError, SupervisorGaveUp,
                            latest_valid_snapshot, load_carry, supervised,
                            validate_snapshot, write_snapshot)
from repro_torch.ft.sync_snapshot import snapshot_as_program
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.checkpoint import (CheckpointError, restore,
                                          restore_engine_state, save,
                                          snapshot_engine_state)
from torch_dist_parity import graph80, run_gloo

pytestmark = pytest.mark.distributed

CPU = "cpu"


def _problem(nv=50, ne=120, seed=3):
    edges = random_graph(nv, ne, seed=seed)
    return pagerank.build(edges, nv, device=CPU)


def _ref_problem(nv=50, ne=120, seed=3):
    return ref_pagerank.build(random_graph(nv, ne, seed=seed), nv)


def _rank(result):
    return result.vertex_data["rank"].numpy()


def _log(restarts):
    return [(r.error_type, r.error, r.backoff_s, r.restored_superstep)
            for r in restarts]


def _both_logs(tmp_path, run_kw, faults, **ft):
    """The restart logs of the same faulted run in both packages."""
    events = [(e.kind, e.superstep, e.shard, e.delay_s) for e in faults]
    g, u, s = _problem()
    got = api.run(g, u, syncs=s, device=CPU, **run_kw, **ft,
                  checkpoint_dir=str(tmp_path / "port"),
                  faults=FaultPlan([FaultEvent(*e) for e in events]))
    rg, ru, rs = _ref_problem()
    want = ref_api.run(rg, ru, syncs=rs, **run_kw, **ft,
                       checkpoint_dir=str(tmp_path / "ref"),
                       faults=RefFaultPlan([RefFaultEvent(*e)
                                            for e in events]))
    assert _log(got.restarts) == _log(want.restarts)
    return got


# ----------------------------------------------------------------------
# Kill / resume, one device and M = 1
# ----------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", ["chromatic", "locking"])
def test_single_device_kill_resume_bitwise(tmp_path, scheduler):
    g, u, s = _problem()
    kw = dict(scheduler=scheduler, max_supersteps=12)
    base = api.run(g, u, syncs=s, device=CPU, **kw)
    assert base.restarts is None
    r = _both_logs(tmp_path, kw, [FaultEvent("kill", 5)],
                   checkpoint_every=2)
    assert [x.error_type for x in r.restarts] == ["InjectedKill"]
    assert r.restarts[0].restored_superstep == 4
    assert r.superstep == base.superstep
    assert r.n_updates == base.n_updates
    assert np.array_equal(_rank(base), _rank(r))


@pytest.mark.parametrize("scheduler", ["chromatic", "locking"])
def test_distributed_m1_kill_resume_bitwise(tmp_path, scheduler):
    g, u, s = _problem()
    assign = np.zeros(g.n_vertices, np.int64)
    kw = dict(scheduler=scheduler, max_supersteps=12, n_shards=1,
              partition=assign)
    base = api.run(g, u, syncs=s, device=CPU, **kw)
    r = _both_logs(tmp_path, kw, [FaultEvent("kill", 5)],
                   checkpoint_every=2)
    assert [x.error_type for x in r.restarts] == ["InjectedKill"]
    assert r.superstep == base.superstep
    assert r.n_updates == base.n_updates
    assert np.array_equal(_rank(base), _rank(r))


def test_kill_with_no_checkpoints_restarts_from_scratch(tmp_path):
    """A kill before the first snapshot restarts from superstep 0 and
    still finishes bitwise (restored_superstep stays None)."""
    g, u, s = _problem()
    base = api.run(g, u, syncs=s, max_supersteps=8, device=CPU)
    r = _both_logs(tmp_path, dict(max_supersteps=8),
                   [FaultEvent("kill", 1)], checkpoint_every=5)
    assert r.restarts[0].restored_superstep is None
    assert np.array_equal(_rank(base), _rank(r))


def test_transient_and_straggle(tmp_path):
    g, u, s = _problem()
    base = api.run(g, u, syncs=s, max_supersteps=10, device=CPU)
    faults = FaultPlan([FaultEvent("transient", superstep=3),
                        FaultEvent("straggle", superstep=5,
                                   delay_s=0.001)])
    r = api.run(g, u, syncs=s, max_supersteps=10, checkpoint_every=2,
                checkpoint_dir=str(tmp_path), faults=faults, device=CPU)
    # straggle delays but never restarts; transient restarts once
    assert [x.error_type for x in r.restarts] == ["TransientFault"]
    assert faults.all_fired
    assert np.array_equal(_rank(base), _rank(r))
    _both_logs(tmp_path / "logs", dict(max_supersteps=10),
               [FaultEvent("transient", 3),
                FaultEvent("straggle", 5, 0, 0.001)], checkpoint_every=2)


def test_supervisor_gives_up(tmp_path):
    g, u, s = _problem()
    kw = dict(max_supersteps=10, checkpoint_every=2, max_restarts=1)
    with pytest.raises(SupervisorGaveUp, match="after 1 restart") as got:
        api.run(g, u, syncs=s, device=CPU, checkpoint_dir=str(tmp_path / "a"),
                faults=FaultPlan([FaultEvent("kill", k) for k in (2, 3, 4)]),
                **kw)
    rg, ru, rs = _ref_problem()
    with pytest.raises(Exception) as want:
        ref_api.run(rg, ru, syncs=rs, checkpoint_dir=str(tmp_path / "b"),
                    faults=RefFaultPlan([RefFaultEvent("kill", k)
                                         for k in (2, 3, 4)]), **kw)
    assert str(got.value) == str(want.value)


def test_until_composes_with_checkpointing(tmp_path):
    g, u, s = _problem()

    def make_stop(n):      # fires at the n-th boundary check
        seen = []

        def stop(g):
            seen.append(0)
            return len(seen) >= n
        return stop

    base = api.run(g, u, syncs=s, until=make_stop(4), device=CPU)
    r = api.run(g, u, syncs=s, until=make_stop(4), checkpoint_every=2,
                checkpoint_dir=str(tmp_path), device=CPU)
    assert r.superstep == base.superstep == 3
    assert r.restarts == []
    assert np.array_equal(_rank(base), _rank(r))


# ----------------------------------------------------------------------
# resume_from through the facade
# ----------------------------------------------------------------------

def test_resume_from_rebuilds_plan_and_continues_bitwise(tmp_path):
    g, u, s = _problem()
    assign = np.zeros(g.n_vertices, np.int64)
    kw = dict(syncs=s, scheduler="chromatic", n_shards=1, partition=assign,
              device=CPU)
    api.run(g, u, **kw, num_supersteps=6, checkpoint_every=3,
            checkpoint_dir=str(tmp_path))
    snap = latest_valid_snapshot(str(tmp_path))
    assert snap is not None and snap.endswith("step_00000006")
    # no partition= passed: the plan is rebuilt from the snapshot
    resumed = api.run(g, u, syncs=s, scheduler="chromatic",
                      num_supersteps=10, resume_from=snap, device=CPU)
    full = api.run(g, u, **kw, num_supersteps=10)
    assert resumed.superstep == 10
    assert resumed.n_updates == full.n_updates
    assert np.array_equal(_rank(full), _rank(resumed))


def test_resume_from_single_device_state_file(tmp_path):
    g, u, s = _problem()
    api.run(g, u, syncs=s, num_supersteps=5, checkpoint_every=5,
            checkpoint_dir=str(tmp_path), device=CPU)
    f = os.path.join(str(tmp_path), "state_step_00000005.npz")
    assert os.path.exists(f)
    resumed = api.run(g, u, syncs=s, num_supersteps=9, resume_from=f,
                      device=CPU)
    full = api.run(g, u, syncs=s, num_supersteps=9, device=CPU)
    assert resumed.superstep == 9
    assert np.array_equal(_rank(full), _rank(resumed))


def _errors(port_call, ref_call):
    """The same refused call in both packages: the messages."""
    with pytest.raises(Exception) as got:
        port_call()
    with pytest.raises(Exception) as want:
        ref_call()
    assert type(got.value).__name__ == type(want.value).__name__
    return str(got.value), str(want.value)


def test_resume_from_wrong_scheduler_or_partition_refused(tmp_path):
    g, u, s = _problem()
    assign = np.zeros(g.n_vertices, np.int64)
    api.run(g, u, syncs=s, n_shards=1, partition=assign, num_supersteps=4,
            checkpoint_every=2, checkpoint_dir=str(tmp_path), device=CPU)
    snap = latest_valid_snapshot(str(tmp_path))
    rg, ru, rs = _ref_problem()
    for kw, part in (({"scheduler": "locking"}, "scheduler"),
                     ({"n_shards": 2}, "shards")):
        got, want = _errors(
            lambda: api.run(g, u, syncs=s, num_supersteps=8,
                            resume_from=snap, device=CPU, **kw),
            lambda: ref_api.run(rg, ru, syncs=rs, num_supersteps=8,
                                resume_from=snap, **kw))
        assert got == want and part in got
    # a plan with another partition identity is refused at load
    eng = api.build_engine(g, u, syncs=s, n_shards=1, partition=assign,
                           device=CPU)
    with pytest.raises(SnapshotError, match="partition fingerprint"):
        load_carry(snap, eng.init_carry(), expect_partition="deadbeef")


# ----------------------------------------------------------------------
# Snapshot integrity: atomicity, torn writes, digests
# ----------------------------------------------------------------------

def _engine_and_carry(nv=40):
    g, u, s = _problem(nv=nv, ne=90)
    assign = np.zeros(g.n_vertices, np.int64)
    eng = api.build_engine(g, u, syncs=s, n_shards=1, partition=assign,
                           device=CPU)
    carry = eng.step_chunk(eng.init_carry(), 3)
    return eng, carry


def _kw(plan):
    return dict(scheduler="chromatic", partition=plan.partition_fingerprint,
                assignment=plan.assignment)


def test_checkpoint_write_fault_leaves_previous_snapshot_valid(tmp_path):
    eng, carry = _engine_and_carry()
    plan = eng.plan
    first = write_snapshot(str(tmp_path), carry, **_kw(plan))
    carry2 = eng.step_chunk(carry, 6)
    faults = FaultPlan([FaultEvent("checkpoint_fail", superstep=6)])
    with pytest.raises(CheckpointWriteFault):
        write_snapshot(str(tmp_path), carry2, **_kw(plan), faults=faults)
    # the torn attempt never published; the previous snapshot is the
    # newest valid one and still loads
    assert latest_valid_snapshot(str(tmp_path)) == first
    assert os.path.isdir(os.path.join(str(tmp_path), ".tmp_step_00000006"))
    restored, step = load_carry(first, eng.init_carry(),
                                expect_partition=plan.partition_fingerprint)
    assert step == 3 and restored["superstep"] == 3
    assert torch.equal(restored["vertex_data"][0]["rank"],
                       carry["vertex_data"][0]["rank"])


def test_corrupted_and_truncated_snapshots_are_skipped(tmp_path):
    eng, carry = _engine_and_carry()
    kw = _kw(eng.plan)
    good = write_snapshot(str(tmp_path), carry, **kw)
    bad = write_snapshot(str(tmp_path), eng.step_chunk(carry, 5), **kw)
    assert latest_valid_snapshot(str(tmp_path)) == bad

    # flip bytes in a shard file: digest mismatch
    shard = os.path.join(bad, "shard_00000.npz")
    blob = bytearray(open(shard, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(shard, "wb").write(bytes(blob))
    with pytest.raises(SnapshotError, match="digest mismatch"):
        validate_snapshot(bad)
    assert latest_valid_snapshot(str(tmp_path)) == good

    # truncate the file entirely
    open(shard, "wb").close()
    with pytest.raises(SnapshotError, match="digest mismatch"):
        validate_snapshot(bad)

    # remove it: named as missing
    os.remove(shard)
    with pytest.raises(SnapshotError, match="missing file"):
        validate_snapshot(bad)

    # corrupt the manifest json
    mpath = os.path.join(good, "MANIFEST.json")
    open(mpath, "w").write("{not json")
    with pytest.raises(SnapshotError, match="unreadable manifest"):
        validate_snapshot(good)
    assert latest_valid_snapshot(str(tmp_path)) is None

    # no manifest at all (torn directory)
    os.remove(mpath)
    with pytest.raises(SnapshotError, match="no MANIFEST.json"):
        validate_snapshot(good)


def test_snapshot_identity_checks(tmp_path):
    eng, carry = _engine_and_carry()
    plan = eng.plan
    p = write_snapshot(str(tmp_path), carry, **_kw(plan))
    validate_snapshot(p, expect_partition=plan.partition_fingerprint,
                      expect_scheduler="chromatic", expect_n_shards=1)
    with pytest.raises(SnapshotError, match="scheduler"):
        validate_snapshot(p, expect_scheduler="locking")
    with pytest.raises(SnapshotError, match="shards"):
        validate_snapshot(p, expect_n_shards=8)
    with pytest.raises(SnapshotError, match="partition fingerprint"):
        validate_snapshot(p, expect_partition="0000000000000000")


def test_snapshot_files_hold_the_reference_layout(tmp_path):
    """The files name the reference's keys and dtypes: int32 counters,
    a 0-d int32 superstep, globals on the host."""
    eng, carry = _engine_and_carry()
    p = write_snapshot(str(tmp_path), carry, **_kw(eng.plan))
    with open(os.path.join(p, "MANIFEST.json")) as f:
        man = json.load(f)
    assert man["fields"]["n_updates"] == {"dtype": "int32", "shape": [1]}
    assert man["fields"]["superstep"] == {"dtype": "int32", "shape": []}
    assert man["fields"]["vertex_data::rank"]["dtype"] == "float32"
    host = np.load(os.path.join(p, "host.npz"))
    assert sorted(host.files) == ["__assignment__", "globals::top2::0",
                                  "globals::top2::1", "globals::total_rank",
                                  "superstep"]
    assert host["superstep"].dtype == np.int32
    shard = np.load(os.path.join(p, "shard_00000.npz"))
    assert shard["n_updates"].dtype == np.int32


def test_counter_past_int32_is_refused(tmp_path):
    eng, carry = _engine_and_carry()
    carry = dict(carry, n_updates=[torch.tensor(2 ** 31, dtype=torch.int64)])
    with pytest.raises(CheckpointError, match="does not fit"):
        write_snapshot(str(tmp_path), carry, **_kw(eng.plan))
    g, u, s = _problem()
    state = api.build_engine(g, u, syncs=s, device=CPU).init_state()
    state = dataclasses.replace(state, n_updates=torch.tensor(2 ** 31))
    with pytest.raises(CheckpointError, match="does not fit"):
        snapshot_engine_state(str(tmp_path / "s.npz"), state)


# ----------------------------------------------------------------------
# Round trip: the port's carry layout across dtypes and shard counts
# ----------------------------------------------------------------------

_DTYPES = [torch.float32, torch.int32, torch.bool, torch.bfloat16]


def _roundtrip_once(d, m, r, dtype, step, seed):
    """write_snapshot >> load_carry is the identity on any carry-shaped
    tree: bitwise, dtype-preserving (the bfloat16 recast included), at
    any shard count and superstep."""
    gen = torch.Generator().manual_seed(seed)

    def arr(*shape):
        raw = torch.randn(shape, generator=gen, dtype=torch.float64) * 100
        return raw > 0 if dtype == torch.bool else raw.to(dtype)

    carry = {
        "vertex_data": [{"x": arr(r), "y": arr(r, 2)} for _ in range(m)],
        "edge_data": [{"w": arr(r + 1)} for _ in range(m)],
        "active": [torch.randint(0, 2, (r,), generator=gen).bool()
                   for _ in range(m)],
        "priority": [torch.randn(r, generator=gen) for _ in range(m)],
        "globals": [{"total": arr()}] * m,
        "superstep": step,
        "n_updates": [torch.randint(0, 99, (), generator=gen)
                      for _ in range(m)],
    }
    p = write_snapshot(str(d), carry, scheduler="chromatic",
                       partition="abc", assignment=np.zeros(4, np.int64))
    like = {k: (v if k == "superstep" else
                [ckpt.map_with_keys(lambda _, t: torch.zeros_like(t), x)
                 for x in v]) for k, v in carry.items()}
    restored, got_step = load_carry(p, like, expect_partition="abc")
    assert got_step == step and restored["superstep"] == step
    want = ckpt.flat_items({k: v for k, v in carry.items()
                            if k != "superstep"})
    got = ckpt.flat_items({k: v for k, v in restored.items()
                           if k != "superstep"})
    assert [k for k, _ in want] == [k for k, _ in got]
    for (k, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype, k
        assert torch.equal(a, b), k


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
@pytest.mark.parametrize("m", [1, 3])
def test_sharded_snapshot_roundtrip_matrix(tmp_path, dtype, m):
    _roundtrip_once(tmp_path, m, 4, dtype, step=7, seed=0)


if HAVE_HYPOTHESIS:
    @settings(max_examples=15, deadline=None)
    @given(seed=st.integers(0, 2**31),
           m=st.integers(min_value=1, max_value=3),
           r=st.integers(min_value=1, max_value=5),
           dtype_idx=st.integers(min_value=0, max_value=len(_DTYPES) - 1),
           step=st.integers(min_value=0, max_value=10_000))
    def test_sharded_snapshot_roundtrip_property(tmp_path_factory, seed, m,
                                                 r, dtype_idx, step):
        d = tmp_path_factory.mktemp("snap")
        _roundtrip_once(d, m, r, _DTYPES[dtype_idx], step, seed)


# ----------------------------------------------------------------------
# train.checkpoint: atomic save, CheckpointError, schema
# ----------------------------------------------------------------------

def test_atomic_save_leaves_no_tmp_residue(tmp_path):
    p = str(tmp_path / "ck.npz")
    save(p, {"a": torch.arange(4)}, step=7)
    save(p, {"a": torch.arange(4) * 2}, step=8)   # overwrite in place
    assert os.listdir(str(tmp_path)) == ["ck.npz"]
    tree, step = restore(p, {"a": torch.zeros(4, dtype=torch.int32)})
    assert step == 8 and tree["a"].dtype == torch.int32
    assert int(tree["a"][3]) == 6


def test_restore_errors_are_named(tmp_path):
    p = str(tmp_path / "ck.npz")
    with pytest.raises(CheckpointError, match="not found"):
        restore(p, {"a": torch.zeros(2)})
    open(p, "wb").write(b"this is not a zip archive")
    with pytest.raises(CheckpointError, match="corrupt"):
        restore(p, {"a": torch.zeros(2)})
    save(p, {"a": torch.zeros(2)})
    with pytest.raises(CheckpointError, match="missing key 'b'"):
        restore(p, {"b": torch.zeros(2)})
    with pytest.raises(CheckpointError, match="shape"):
        restore(p, {"a": torch.zeros(3)})


def test_checkpoint_roundtrip_both_directions(tmp_path):
    """``save`` / ``restore`` of nested trees with bfloat16 leaves, each
    package reading the other's file."""
    import jax.numpy as jnp
    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "b": {"c": torch.tensor([1.5, 2.5])}, "l": [torch.tensor(3)]}
    ref_tree = {"a": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3),
                "b": {"c": jnp.asarray([1.5, 2.5])},
                "l": [jnp.asarray(3, jnp.int64)]}
    save(str(tmp_path / "port.npz"), tree, step=7)
    got, step = ref_ckpt.restore(str(tmp_path / "port.npz"), ref_tree)
    assert step == 7 and got["a"].dtype == jnp.bfloat16
    ref_ckpt.save(str(tmp_path / "ref.npz"), ref_tree, step=9)
    back, step = restore(str(tmp_path / "ref.npz"), tree)
    assert step == 9 and back["a"].dtype == torch.bfloat16
    for k in ("a", "b::c", "l::0"):
        want = dict(ckpt.flat_items(tree))[k].float().numpy()
        assert np.array_equal(np.asarray(dict(
            (".".join(map(str, p)), v) for p, v in
            _ref_flat(got))[k.replace("::", ".")], np.float32), want)
        assert np.array_equal(dict(ckpt.flat_items(back))[k].float().numpy(),
                              want)


def _ref_flat(tree):
    import jax
    return [(tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path),
             leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_engine_snapshot_schema_and_field_guards(tmp_path):
    g, u, s = _problem(nv=30, ne=60)
    eng = api.build_engine(g, u, syncs=s, device=CPU)
    state = eng.init_state(None, None)
    p = str(tmp_path / "snap.npz")
    snapshot_engine_state(p, state)
    restored = restore_engine_state(p, state)
    assert restored.superstep == state.superstep
    assert restored.n_updates.dtype == torch.int64

    # unversioned snapshot (pre-schema format): refused by name
    flat = dict(np.load(p))
    del flat["__schema__"]
    np.savez(p[:-4], **flat)
    with pytest.raises(CheckpointError, match="not a versioned"):
        restore_engine_state(p, state)

    # wrong schema number
    flat["__schema__"] = np.asarray(99)
    np.savez(p[:-4], **flat)
    with pytest.raises(CheckpointError, match="schema 99"):
        restore_engine_state(p, state)

    # field-set drift: the mismatched fields are named, as the
    # reference names them
    flat["__schema__"] = np.asarray(ckpt.ENGINE_SNAPSHOT_SCHEMA)
    flat["__fields__"] = np.asarray("vertex_data,active")
    np.savez(p[:-4], **flat)
    with pytest.raises(CheckpointError, match="missing.*superstep") as got:
        restore_engine_state(p, state)
    rg, ru, rs = _ref_problem(nv=30, ne=60)
    ref_state = ref_api.build_engine(rg, ru, syncs=rs).init_state(None,
                                                                  None)
    with pytest.raises(ref_ckpt.CheckpointError) as want:
        ref_ckpt.restore_engine_state(p, ref_state)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("engine", ["chromatic", "locking"])
def test_snapshot_engine_state_resume_bit_identical(tmp_path, engine):
    """§8 consistent snapshot: snapshot mid-run, restore, and the resumed
    run is bitwise the uninterrupted one: task set, priorities, syncs and
    counters included (``tests/test_optim_ckpt.py``'s twin)."""
    edges = random_graph(40, 90, seed=7)
    g = pagerank.make_graph(edges, 40, device=CPU)
    upd = pagerank.make_update(1e-5)
    syncs = [pagerank.total_rank_sync()]
    if engine == "chromatic":
        eng = ChromaticEngine(g, upd, syncs=syncs, max_supersteps=100)
    else:
        eng = LockingEngine(g, upd, syncs=syncs, max_pending=8,
                            max_supersteps=5000)
    full = eng.run(num_supersteps=10)
    half = eng.run(num_supersteps=5)
    path = str(tmp_path / "mid.npz")
    snapshot_engine_state(path, half)
    restored = restore_engine_state(path, eng.init_state())
    assert restored.superstep == 5
    resumed = eng.resume(restored, num_supersteps=5)
    assert resumed.superstep == full.superstep
    assert int(resumed.n_updates) == int(full.n_updates)
    for a, b in ((resumed.vertex_data, full.vertex_data),
                 (resumed.globals, full.globals)):
        for (k, x), (_, y) in zip(ckpt.flat_items(a), ckpt.flat_items(b)):
            assert torch.equal(x, y), k
    assert torch.equal(resumed.active, full.active)
    assert torch.equal(resumed.priority, full.priority)


# ----------------------------------------------------------------------
# §8: the snapshot as a GraphLab program
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 3])
def test_sync_snapshot_program_matches_direct_copy(n_shards):
    g, u, s = _problem(nv=30, ne=60)
    r = api.run(g, u, syncs=s, num_supersteps=3, device=CPU)
    moved = dataclasses.replace(g, vertex_data=r.vertex_data)
    assign = np.arange(g.n_vertices) % n_shards
    snap = snapshot_as_program(moved, scheduler="chromatic",
                               n_shards=n_shards, partition=assign,
                               device=CPU)
    assert set(snap) == {"rank"}
    assert torch.equal(snap["rank"], moved.vertex_data["rank"])


# ----------------------------------------------------------------------
# FaultPlan / supervisor units
# ----------------------------------------------------------------------

def test_fault_plan_seeded_is_deterministic_and_the_references():
    kw = dict(n_shards=8, max_superstep=20, n_events=3,
              kinds=("kill", "transient"))
    a, b = FaultPlan.seeded(7, **kw), FaultPlan.seeded(7, **kw)
    ref = RefFaultPlan.seeded(7, **kw)
    events = lambda p: [(e.kind, e.superstep, e.shard, e.delay_s)
                        for e in p.events]
    assert events(a) == events(b) == events(ref)
    assert a.next_trigger(0) == min(e.superstep for e in a.events)
    for e in a.events:
        e.fired = True
    assert a.next_trigger(0) is None and a.all_fired
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent("meteor", 1)


def test_supervisor_backoff_and_log():
    sleeps = []
    calls = []

    def attempt(n, restarts):
        calls.append(n)
        if n < 2:
            raise CheckpointWriteFault(f"boom {n}")
        return "done"

    out, restarts = supervised(attempt, max_restarts=3,
                               backoff_base_s=0.5, backoff_factor=2.0,
                               backoff_max_s=10.0, sleep=sleeps.append)
    assert out == "done" and calls == [0, 1, 2]
    assert sleeps == [0.5, 1.0]
    assert [r.error_type for r in restarts] \
        == ["CheckpointWriteFault", "CheckpointWriteFault"]

    def bad(n, restarts):
        raise RuntimeError("not injected")
    with pytest.raises(RuntimeError):
        supervised(bad, sleep=sleeps.append)


_BAD_OPTIONS = {
    "alone": dict(checkpoint_every=2),
    "zero": dict(checkpoint_every=0, checkpoint_dir="/nonexistent/x"),
    "bool": dict(checkpoint_every=True, checkpoint_dir="/nonexistent/x"),
    "restarts": dict(max_restarts=-1),
    "trace": dict(trace=True, faults="plan"),
    "profile": dict(profile=True, checkpoint_every=1,
                    checkpoint_dir="/nonexistent/x"),
    "sequential": dict(scheduler="sequential", faults="plan"),
    "serve-only": dict(slack=4),
}


@pytest.mark.parametrize("case", sorted(_BAD_OPTIONS))
def test_api_ft_kwarg_validation(case):
    g, u, s = _problem(nv=20, ne=40)
    rg, ru, rs = _ref_problem(nv=20, ne=40)
    kw = dict(_BAD_OPTIONS[case])
    port_kw, ref_kw = dict(kw), dict(kw)
    if kw.get("faults") == "plan":
        port_kw["faults"], ref_kw["faults"] = FaultPlan([]), RefFaultPlan([])
    got, want = _errors(lambda: api.run(g, u, syncs=s, device=CPU,
                                        **port_kw),
                        lambda: ref_api.run(rg, ru, syncs=rs, **ref_kw))
    assert got == want


# ----------------------------------------------------------------------
# Interchange, one device: state_step_*.npz both ways (CC, bitwise)
# ----------------------------------------------------------------------

_CC_N = (90, 220, 11)      # nv, ne, seed


def _cc_graphs():
    nv, ne, seed = _CC_N
    edges = random_graph(nv, ne, seed=seed)
    port = cc.build(edges, nv, device=CPU)
    ref = ref_cc.build(edges, nv)
    return port, ref


def _same_cc(got, want_labels, want_counts):
    assert np.array_equal(got.vertex_data["label"].numpy(), want_labels)
    assert [got.superstep, got.n_updates] == list(want_counts)


@pytest.mark.parametrize("scheduler", ["chromatic", "locking"])
def test_single_device_snapshots_interchange(tmp_path, scheduler):
    (g, u, _), (rg, ru, _) = _cc_graphs()
    kw = dict(scheduler=scheduler, num_supersteps=8)
    if scheduler == "locking":
        kw["max_pending"] = 4
    # the reference writes; the port resumes and finishes its run
    ref_full = ref_api.run(rg, ru, **kw, checkpoint_every=4,
                           checkpoint_dir=str(tmp_path / "ref"))
    want = (np.asarray(ref_full.vertex_data["label"]),
            (ref_full.superstep, ref_full.n_updates))
    got = api.run(g, u, **kw, device=CPU, resume_from=str(
        tmp_path / "ref" / "state_step_00000004.npz"))
    _same_cc(got, *want)
    # the port writes; the reference resumes and finishes the port's run
    port_full = api.run(g, u, **kw, device=CPU, checkpoint_every=4,
                        checkpoint_dir=str(tmp_path / "port"))
    _same_cc(port_full, *want)
    back = ref_api.run(rg, ru, **kw, resume_from=str(
        tmp_path / "port" / "state_step_00000004.npz"))
    assert np.array_equal(np.asarray(back.vertex_data["label"]),
                          port_full.vertex_data["label"].numpy())
    assert [back.superstep, back.n_updates] == [port_full.superstep,
                                                port_full.n_updates]


# ----------------------------------------------------------------------
# M = 8: the reference's acceptance matrix, and sharded interchange
# ----------------------------------------------------------------------

_MATRIX = [("checkpoint_fail", 4, 0), ("kill", 6, 3), ("transient", 9, 0)]
_CC_STEPS, _CC_AT, _CC_PENDING = 12, 4, 4

_REF_SCRIPT = f"""
    import json
    from repro import api
    from repro.apps import cc, pagerank
    from repro.core import two_phase_partition
    from repro.ft import FaultEvent, FaultPlan
    PORT_DIR, REF_DIR = sys.argv[2], sys.argv[3]
    edges = graph80()
    out = {{}}
    graph, update, syncs = pagerank.build(edges, 80)
    assign = two_phase_partition(80, graph.edges_np, 8, seed=0)
    for scheduler in ("chromatic", "locking"):
        r = api.run(graph, update, syncs=syncs, scheduler=scheduler,
                    n_shards=8, partition=assign, max_supersteps=12,
                    checkpoint_every=2,
                    checkpoint_dir=os.path.join(REF_DIR, "pr_" + scheduler),
                    faults=FaultPlan([FaultEvent(*e) for e in {_MATRIX}]))
        out["log_" + scheduler] = json.dumps(
            [[x.error_type, x.error, x.backoff_s, x.restored_superstep]
             for x in r.restarts])
    g, u, _ = cc.build(edges, 80)
    for scheduler in ("chromatic", "locking"):
        kw = dict(scheduler=scheduler, n_shards=8, partition=assign,
                  num_supersteps={_CC_STEPS})
        if scheduler == "locking":
            kw["max_pending"] = {_CC_PENDING}
        r = api.run(g, u, **kw, checkpoint_every={_CC_AT},
                    checkpoint_dir=os.path.join(REF_DIR, "cc_" + scheduler))
        out["cc_" + scheduler] = np.asarray(r.vertex_data["label"])
        out["cc_counts_" + scheduler] = [
            r.superstep, r.n_updates, r.stats.get("ghost_rows_sent", -1),
            r.stats.get("ghost_rows_full", -1)]
        kw.pop("partition")
        r = api.run(g, u, **kw, resume_from=os.path.join(
            PORT_DIR, "cc_" + scheduler, "step_{_CC_AT:08d}"))
        out["back_" + scheduler] = np.asarray(r.vertex_data["label"])
        out["back_counts_" + scheduler] = [
            r.superstep, r.n_updates, r.stats.get("ghost_rows_sent", -1),
            r.stats.get("ghost_rows_full", -1)]
    np.savez(OUT, **out)
"""


def _cc80(scheduler, **kw):
    edges = graph80()
    g, u, _ = cc.build(edges, 80, device=CPU)
    # the reference script's assignment (its PageRank graph stores the
    # edges in input order)
    assign = two_phase_partition(80, edges, 8, seed=0)
    kw = dict(kw, scheduler=scheduler, n_shards=8, partition=assign,
              num_supersteps=_CC_STEPS, device=CPU)
    if scheduler == "locking":
        kw["max_pending"] = _CC_PENDING
    return g, u, kw


def _counts(r):
    return [r.superstep, r.n_updates, r.stats.get("ghost_rows_sent", -1),
            r.stats.get("ghost_rows_full", -1)]


@pytest.fixture(scope="module")
def ref8(tmp_path_factory):
    """The port writes its M = 8 CC snapshots first; then one reference
    subprocess runs the fault matrix, writes its own CC snapshots and
    resumes the port's."""
    root = tmp_path_factory.mktemp("ft8")
    port_dir, ref_dir = root / "port", root / "ref"
    port = {}
    for scheduler in ("chromatic", "locking"):
        g, u, kw = _cc80(scheduler)
        r = api.run(g, u, **kw, checkpoint_every=_CC_AT,
                    checkpoint_dir=str(port_dir / f"cc_{scheduler}"))
        port[scheduler] = (r.vertex_data["label"].numpy(), _counts(r))
    import subprocess
    import sys
    import textwrap
    from torch_dist_parity import REF_PRELUDE, ROOT
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = root / "ref.npz"
    proc = subprocess.run(
        [sys.executable, "-c", REF_PRELUDE + textwrap.dedent(_REF_SCRIPT),
         str(out), str(port_dir), str(ref_dir)], env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        ref = {k: z[k] for k in z.files}
    return dict(ref=ref, port=port, ref_dir=ref_dir)


@pytest.mark.parametrize("scheduler", ["chromatic", "locking"])
def test_8shard_kill_recovery_bitwise(ref8, tmp_path, scheduler):
    """The acceptance criterion on the port's ``LocalMesh``: an 8-shard
    run with an injected checkpoint-write failure, a shard kill and a
    transient host error recovers and matches the unfaulted run bitwise
    (ghost traffic included under locking), with the reference's
    restart log."""
    graph, update, syncs = pagerank.build(graph80(), 80, device=CPU)
    assign = two_phase_partition(80, graph.edges_np, 8, seed=0)
    kw = dict(syncs=syncs, scheduler=scheduler, n_shards=8,
              partition=assign, max_supersteps=12, device=CPU)
    base = api.run(graph, update, **kw)
    r = api.run(graph, update, **kw, checkpoint_every=2,
                checkpoint_dir=str(tmp_path),
                faults=FaultPlan([FaultEvent(*e) for e in _MATRIX]))
    assert np.array_equal(_rank(base), _rank(r))
    assert (r.superstep, r.n_updates) == (base.superstep, base.n_updates)
    assert [x.error_type for x in r.restarts] == [
        "CheckpointWriteFault", "InjectedKill", "TransientFault"]
    assert [list(x) for x in _log(r.restarts)] == json.loads(
        str(ref8["ref"][f"log_{scheduler}"]))
    if scheduler == "locking":
        got = [r.stats["ghost_rows_sent"], r.stats["ghost_rows_full"]]
        assert got == [base.stats["ghost_rows_sent"],
                       base.stats["ghost_rows_full"]]
        assert 0 < got[0] < got[1]


def test_8shard_resume_from_rebuilds_the_plan(tmp_path):
    graph, update, syncs = pagerank.build(graph80(), 80, device=CPU)
    assign = two_phase_partition(80, graph.edges_np, 8, seed=0)
    kw = dict(syncs=syncs, scheduler="chromatic", n_shards=8, device=CPU)
    api.run(graph, update, **kw, partition=assign, num_supersteps=6,
            checkpoint_every=6, checkpoint_dir=str(tmp_path))
    snap = latest_valid_snapshot(str(tmp_path))
    resumed = api.run(graph, update, **kw, num_supersteps=12,
                      resume_from=snap)
    full = api.run(graph, update, **kw, partition=assign, num_supersteps=12)
    assert np.array_equal(_rank(full), _rank(resumed))
    assert resumed.n_updates == full.n_updates


@pytest.mark.parametrize("scheduler", ["chromatic", "locking"])
def test_8shard_snapshots_interchange(ref8, scheduler):
    """The reference's mid-run snapshot, resumed by the port, finishes
    bitwise the reference's uninterrupted run (the locking engine's
    version counters included: equal ghost traffic); the port's,
    resumed by the reference, finishes bitwise the port's."""
    ref = ref8["ref"]
    want = (ref[f"cc_{scheduler}"], ref[f"cc_counts_{scheduler}"].tolist())
    got_labels, got_counts = ref8["port"][scheduler]
    assert np.array_equal(got_labels, want[0]) and got_counts == want[1]
    g, u, kw = _cc80(scheduler)
    kw.pop("partition")
    r = api.run(g, u, **kw, resume_from=str(
        ref8["ref_dir"] / f"cc_{scheduler}" / f"step_{_CC_AT:08d}"))
    assert np.array_equal(r.vertex_data["label"].numpy(), want[0])
    assert _counts(r) == want[1]
    assert np.array_equal(ref[f"back_{scheduler}"], got_labels)
    assert ref[f"back_counts_{scheduler}"].tolist() == got_counts


# ----------------------------------------------------------------------
# ProcessGroupMesh: two gloo ranks, each writing its own shard
# ----------------------------------------------------------------------

def test_gloo_ranks_write_their_own_shards_and_resume_bitwise(
        tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_FT_DIR", str(tmp_path / "ckpt"))
    got = run_gloo("ft", 2, tmp_path)
    edges = graph80()
    g, u, _ = cc.build(edges, 80, device=CPU)
    kw = dict(scheduler="locking", max_pending=4, n_shards=2,
              num_supersteps=12, device=CPU, mesh=LocalMesh(2, [CPU]))
    base = api.run(g, u, **kw,
                   partition=two_phase_partition(80, g.edges_np, 2, seed=0))
    for key in ("faulted", "resumed"):
        assert np.array_equal(got[f"{key}_label"],
                              base.vertex_data["label"].numpy()), key
        assert got[f"{key}_counts"].tolist() == _counts(base), key
    assert got["restarts"].tolist() == ["InjectedKill"]
    # rank r wrote shard_r of every snapshot and nothing else of them
    for rank in (0, 1):
        files = set(got[f"written_{rank}"].tolist())
        assert f"shard_{rank:05d}.npz" in files
        assert f"shard_{1 - rank:05d}.npz" not in files
    assert "host.npz" in set(got["written_0"].tolist())
    assert "host.npz" not in set(got["written_1"].tolist())


def test_kill_resume_example_runs_on_cpu():
    import subprocess
    import sys
    from torch_dist_parity import ROOT
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "kill_resume_torch.py"),
         "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("bitwise-equal to ground truth: True") == 2
    assert "InjectedKill" in proc.stdout
