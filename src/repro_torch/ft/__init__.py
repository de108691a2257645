"""Fault tolerance for the port's runs (the port of ``repro.ft``; paper
§8, Distributed GraphLab §5): sharded consistent snapshots at superstep
boundaries, deterministic fault injection, and a supervised restart
loop.  The layers (DESIGN.md §12):

* :mod:`repro_torch.ft.snapshot` — per-shard checkpoints of a
  distributed carry, written atomically with a digest-carrying
  manifest, in the reference's file layout.
* :mod:`repro_torch.ft.faults` — a seeded :class:`FaultPlan` of
  injected kills / transient errors / stragglers / checkpoint-write
  failures, zero cost when absent.
* :mod:`repro_torch.ft.supervisor` — retry with backoff around an
  attempt function, restoring from the latest valid snapshot.
* :mod:`repro_torch.ft.runner` — the checkpointed drivers ``api.run(...,
  checkpoint_every=, resume_from=, faults=)`` routes to.
* :mod:`repro_torch.ft.sync_snapshot` — the paper-fidelity §8 variant,
  the snapshot run as an update function through the engine.
"""
from repro_torch.ft.faults import (CheckpointWriteFault, FaultEvent,
                                   FaultPlan, InjectedFault, InjectedKill,
                                   TransientFault)
from repro_torch.ft.snapshot import (SnapshotError, latest_valid_snapshot,
                                     load_carry, read_manifest,
                                     validate_snapshot, write_snapshot)
from repro_torch.ft.supervisor import (RestartRecord, SupervisorGaveUp,
                                       supervised)

__all__ = [
    "CheckpointWriteFault", "FaultEvent", "FaultPlan", "InjectedFault",
    "InjectedKill", "TransientFault", "SnapshotError",
    "latest_valid_snapshot", "load_carry", "read_manifest",
    "validate_snapshot", "write_snapshot", "RestartRecord",
    "SupervisorGaveUp", "supervised",
]
