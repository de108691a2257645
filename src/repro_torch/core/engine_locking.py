"""The locking engine (paper §4.2.2): a port of
``repro.core.engine_locking``'s ``conflict_winners``,
``conflict_winners_windowed``, ``LockingEngine`` and
``DistributedLockingEngine``.

Each superstep puts the ``max_pending`` highest-priority active vertices
in flight (the paper's lock pipeline), and a claim pass grants locks in
canonical min-id order: under FULL consistency a candidate claims its
whole scope (``scope_claims``) and wins iff it holds every claim;
under EDGE it claims its own row (``self_claims``) and wins iff no
pending neighbour has a smaller id; VERTEX and UNSAFE scopes never
conflict.  Winners run as one conflict-free batch, losers stay active
for the next superstep.  No coloring is needed.

``DistributedLockingEngine`` runs the same program on every shard of a
``ShardPlan``: the pending window over the shard's owned rows, claims by
global id min-combined across replicas (ghost -> owner -> ghost over
the symmetric ``tsend/trecv`` channel), the winners through the shared
``apply_batch``, then a **versioned** ghost push: version counters bump
on every execution, and a row travels, and is applied, only when it
changed since it was last sent (the paper's "only transmit modified
data"; the buffers keep their static width, so the saving is counted,
``ghost_rows_sent`` against ``ghost_rows_full``).  Cut-edge replicas
sync the same way.  With a saturating window (``max_pending >= R``)
it equals ``LockingEngine`` at ``max_pending = Nv``, bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core.distributed import (ShardArrays, ShardPlan,
                                          _CarryEngine, dist_refresh_syncs,
                                          task_backflow)
from repro_torch.core.exec import (NO_CLAIM, ExecutorCore,
                                   adjacent_claim_winners, apply_batch,
                                   choose_dispatch, claim_winners,
                                   scope_claims, self_claims, stable_top_k,
                                   switch_on_window_width, validate_dispatch)
from repro_torch.core.graph import DataGraph
from repro_torch.core.registry import (register_distributed,
                                       register_scheduler)
from repro_torch.core.sync import SyncOp
from repro_torch.core.update import Consistency, UpdateFn


def conflict_winners(struct, ids, sel, consistency: Consistency,
                     rows=None):
    """Reader/writer lock grant as one claim scatter and one check, with
    the candidates' adjacency gathered once (``rows``, default
    ``[P, max_deg]``) for both."""
    if consistency == Consistency.FULL:
        rows = struct.struct_rows(ids) if rows is None else rows
        claim = scope_claims(struct, ids, sel, rows=rows)
        return claim_winners(struct, ids, sel, claim, rows=rows)
    if consistency == Consistency.EDGE:
        rows = struct.struct_rows(ids) if rows is None else rows
        claim = self_claims(struct, ids, sel)
        return adjacent_claim_winners(struct, ids, sel, claim, rows=rows)
    return sel      # VERTEX / UNSAFE: no inter-vertex conflicts


def conflict_winners_windowed(struct, ids, sel, consistency: Consistency):
    """``conflict_winners`` with the candidates' adjacency gathered at
    the pending window's snapped width ``[P, W]`` instead of
    ``[P, max_deg]``: the same winners."""
    if consistency not in (Consistency.FULL, Consistency.EDGE):
        return sel

    def at_width(w):
        def f(_):
            return conflict_winners(struct, ids, sel, consistency,
                                    rows=struct.struct_rows(ids, width=w))
        return f
    return switch_on_window_width(struct.ell, ids, sel, at_width, None)


@dataclasses.dataclass
class LockingEngine(ExecutorCore):
    """Strategy: a top-``max_pending`` pending window, min-id claim
    winners.  ``max_pending`` is the lock-pipeline depth of the paper's
    Fig. 8(b): 1 is strictly sequential, more admits more concurrent
    winners a superstep."""

    max_supersteps: int = 2000
    max_pending: int = 64       # P: in-flight scope acquisitions

    def __post_init__(self):
        super().__post_init__()
        self.n_phases = 1

    def prepare(self, state):
        p = min(self.max_pending, self.graph.n_vertices)
        score = torch.where(state.active, state.priority, -torch.inf)
        cand = stable_top_k(score, p)                    # [P] pending window
        cand_sel = state.active[cand.long()]
        consistency = self.update_fn.consistency
        if self.resolve_dispatch(p) == "batch":
            win = conflict_winners_windowed(self.graph, cand, cand_sel,
                                            consistency)
        else:
            win = conflict_winners(self.graph, cand, cand_sel, consistency)
        return cand, win

    def select(self, c: int, ctx):
        return ctx


register_scheduler(
    "locking", LockingEngine, extras=("max_pending",),
    description="pipelined reader/writer lock engine (§4.2.2): "
                "max_pending window + min-id claim winners; needs no "
                "coloring")


# ======================================================================
@dataclasses.dataclass
class DistributedLockingEngine(_CarryEngine):
    """The locking engine over a shard mesh (``LocalMesh`` on the
    graph's device unless ``mesh`` is given).

    A superstep, shard by shard with the exchanges between: pending
    window -> claim pass (+ cross-shard min-combine) -> winners through
    ``apply_batch`` -> version bump -> versioned ghost and edge push ->
    task backflow -> syncs.  One shard is the degenerate case: every
    exchange moves nothing, and the run equals ``LockingEngine``.
    """

    graph: DataGraph
    plan: ShardPlan
    update_fn: UpdateFn
    syncs: Sequence[SyncOp] = ()
    max_supersteps: int = 2000
    max_pending: int = 64
    exchange_edges: bool = False   # app writes edge data on cut edges?
    use_kernel: bool = True
    # "auto": small per-shard windows take the batch-shaped claim pass
    # and [P, W] launches, saturating windows the bucket sweep
    dispatch: str | None = "auto"
    cost_model: Any = None
    mesh: Any = None

    def __post_init__(self):
        validate_dispatch(self.dispatch)
        if (self.update_fn.consistency == Consistency.FULL
                and self.plan.M > 1):
            # FULL neighbour writes land on ghost rows, and no ghost ->
            # owner data backflow exists: fail rather than drop writes
            raise ValueError(
                "FULL-consistency neighbor writes are not supported "
                "across shards (ghost-row writes cannot flow back to "
                "the owner); use the single-shard LockingEngine")
        self._setup_mesh()
        self._sa = [ShardArrays(self.plan, i, self.mesh.device(i),
                                colored=False, edges=self.exchange_edges)
                    for i in self.mesh.shards]
        plan = self.plan
        self._p = min(self.max_pending, plan.R)
        self._mode = choose_dispatch(
            self.dispatch, self._p, plan.ell_widths[-1], plan.sliced_slots,
            cost_model=self.cost_model, bucket_launches=plan.bucket_launches)

    def init_carry(self, active=None) -> dict:
        """The chromatic engine's initial state plus the versioned
        sync's: vertex and edge version counters and the owner-side
        sent-version tables (a snapshot must keep them, or a resumed run
        would ship different rows)."""
        carry = super().init_carry(active)
        plan = self.plan
        for s in self._sa:
            z = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                           device=s.device)
            carry.setdefault("version", []).append(z(plan.R))
            carry.setdefault("eversion", []).append(z(plan.E_loc + 1))
            carry.setdefault("sent_ver", []).append(z(plan.M, plan.Hg))
            carry.setdefault("esent_ver", []).append(z(plan.M, plan.Hc))
            for k in ("ghost_sent", "ghost_full"):
                carry.setdefault(k, []).append(
                    torch.zeros((), dtype=torch.int64, device=s.device))
        return carry

    # -- the claim pass -------------------------------------------------
    def _combine(self, claims: list) -> list:
        """Min-combine claims across replicas: ghost -> owner, then the
        combined value back owner -> ghost (the same channel)."""
        sa, mesh = self._sa, self.mesh
        up = [torch.where(s.ts_mask, c[s.ts_idx], NO_CLAIM)
              for s, c in zip(sa, claims)]
        claims = [c.scatter_reduce(0, s.tr_rows, o.reshape(-1).index_select(
            0, s.tr_pos), "amin")
            for s, c, o in zip(sa, claims, mesh.all_to_all(up))]
        down = [torch.where(s.tr_ok, c[s.tr_safe], NO_CLAIM)
                for s, c in zip(sa, claims)]
        return [c.scatter_reduce(0, s.ts_rows, o.reshape(-1).index_select(
            0, s.ts_pos), "amin")
            for s, c, o in zip(sa, claims, mesh.all_to_all(down))]

    def _winners(self, cands, sels, gids, rows) -> list:
        consistency = self.update_fn.consistency
        if consistency not in (Consistency.FULL, Consistency.EDGE):
            return sels       # VERTEX / UNSAFE: no inter-vertex conflicts
        full = consistency == Consistency.FULL
        structs = [s.struct for s in self._sa]
        grant = claim_winners if full else adjacent_claim_winners
        if self._mode == "bucket":
            claims = [scope_claims(st, c, sl, g, rows=r) if full
                      else self_claims(st, c, sl, g)
                      for st, c, sl, g, r in zip(structs, cands, sels, gids,
                                                  rows)]
            claims = self._combine(claims)
            return [grant(st, c, sl, cl, g, rows=r) for st, c, sl, cl, g, r
                    in zip(structs, cands, sels, claims, gids, rows)]
        # the window's snapped width: each shard switches on its own,
        # the combine runs between the two switches
        claims = []
        for st, c, sl, g in zip(structs, cands, sels, gids):
            if full:
                def claim_at(w, st=st, c=c, sl=sl, g=g):
                    return lambda _: scope_claims(
                        st, c, sl, g, rows=st.struct_rows(c, width=w))
                claims.append(switch_on_window_width(st.ell, c, sl,
                                                     claim_at, None))
            else:
                claims.append(self_claims(st, c, sl, g))
        claims = self._combine(claims)
        wins = []
        for st, c, sl, cl, g in zip(structs, cands, sels, claims, gids):
            def win_at(w, st=st, c=c, sl=sl, g=g):
                return lambda claim: grant(st, c, sl, claim, g,
                                           rows=st.struct_rows(c, width=w))
            wins.append(switch_on_window_width(st.ell, c, sl, win_at, cl))
        return wins

    # -- the versioned pushes -------------------------------------------
    def _push_versioned(self, arrays: list, version: list, sent: list,
                        ok: list, safe: list, pos: list, rows: list):
        """Owner -> replica push that applies only the rows whose version
        advanced since they were last sent to that peer."""
        mesh = self.mesh
        ver = [torch.where(o, v[i], 0) for o, v, i in zip(ok, version, safe)]
        fresh = [o & (v > s) for o, v, s in zip(ok, ver, sent)]
        fresh_r = [(f.reshape(-1) > 0).index_select(0, p) for f, p in zip(
            mesh.all_to_all([f.to(torch.int32) for f in fresh]), pos)]
        out = [dict(a) for a in arrays]
        for key in arrays[0]:
            vals = [a[key] for a in arrays]
            bufs = [v.index_select(0, i.reshape(-1)).reshape(
                tuple(i.shape) + tuple(v.shape[1:]))
                for v, i in zip(vals, safe)]
            for k, (v, o, p, r, fr) in enumerate(zip(
                    vals, mesh.all_to_all(bufs), pos, rows, fresh_r)):
                got = o.reshape((-1,) + tuple(v.shape[1:])).index_select(0, p)
                keep = v.index_select(0, r)
                fr_b = fr.reshape((-1,) + (1,) * (v.dim() - 1))
                out[k][key] = v.index_copy(0, r, torch.where(fr_b, got, keep))
        new_sent = [torch.where(f, v, s) for f, v, s in zip(fresh, ver, sent)]
        return out, new_sent, fresh

    def _superstep(self, carry: dict) -> dict:
        sa, upd = self._sa, self.update_fn
        c = {k: list(v) if isinstance(v, list) else v
             for k, v in carry.items()}
        cands, sels = [], []
        for s, act, pri in zip(sa, c["active"], c["priority"]):
            oa = act & s.owned
            cand = stable_top_k(torch.where(oa, pri, -torch.inf), self._p)
            sel = oa[cand.long()]
            if self._mode == "bucket" and sel.numel():
                # a bucket-shaped window (a saturating one) ends at its
                # last pending row (one host read): the rows past it are
                # not pending and take no part in the claim pass or the
                # batch, so the run is the padded window's
                k = int(torch.where(sel, torch.arange(
                    1, sel.numel() + 1, device=sel.device), 0).max())
                cand, sel = cand[:k], sel[:k]
            cands.append(cand)
            sels.append(sel)
        gids = [s.global_ids[cd.long()] for s, cd in zip(sa, cands)]
        rows = ([s.struct.struct_rows(cd) for s, cd in zip(sa, cands)]
                if self._mode == "bucket" else [None] * len(sa))
        wins = self._winners(cands, sels, gids, rows)
        for k, s in enumerate(sa):
            (c["vertex_data"][k], c["edge_data"][k], c["active"][k],
             c["priority"][k], c["n_updates"][k]) = apply_batch(
                s.struct, upd,
                (c["vertex_data"][k], c["edge_data"][k], c["active"][k],
                 c["priority"][k], c["n_updates"][k]),
                cands[k], wins[k], c["globals"][k],
                use_kernel=self.use_kernel, rows=rows[k],
                dispatch=self._mode)
            cd, win = cands[k].long(), wins[k]
            c["version"][k] = c["version"][k].index_add(
                0, cd, win.to(torch.int32))
            if self.exchange_edges:
                def bump(r, ev, win=win):
                    emask = r.nbr_mask & win[:, None]
                    return ev.index_add(0, r.edge_ids.reshape(-1).long(),
                                        emask.reshape(-1).to(torch.int32))
                if self._mode == "bucket":
                    c["eversion"][k] = bump(rows[k], c["eversion"][k])
                else:
                    def bump_at(w, s=s, cd=cands[k]):
                        return lambda ev: bump(s.struct.struct_rows(
                            cd, width=w), ev)
                    c["eversion"][k] = switch_on_window_width(
                        s.struct.ell, cands[k], win, bump_at,
                        c["eversion"][k])
        c["vertex_data"], c["sent_ver"], fresh = self._push_versioned(
            c["vertex_data"], c["version"], c["sent_ver"],
            [s.tr_ok for s in sa], [s.tr_safe for s in sa],
            [s.ts_pos for s in sa], [s.ts_rows for s in sa])
        for k, s in enumerate(sa):
            c["ghost_sent"][k] = c["ghost_sent"][k] + fresh[k].sum()
            c["ghost_full"][k] = c["ghost_full"][k] + s.tr_ok.sum()
        if self.exchange_edges:
            c["edge_data"], c["esent_ver"], _ = self._push_versioned(
                c["edge_data"], c["eversion"], c["esent_ver"],
                [s.ce_mask for s in sa], [s.ce_idx for s in sa],
                [s.cr_pos for s in sa], [s.cr_rows for s in sa])
        c["active"], c["priority"] = task_backflow(
            self.mesh, sa, c["active"], c["priority"])
        c["globals"] = dist_refresh_syncs(
            self.mesh, self.syncs, c["globals"], c["vertex_data"],
            [s.owned for s in sa], c["superstep"])
        c["superstep"] = c["superstep"] + 1
        return c

    def finalize(self, carry: dict) -> dict:
        out = super().finalize(carry)
        # version-filtered traffic against what a static push would send
        for k in ("ghost_sent", "ghost_full"):
            total = self.mesh.psum([x.reshape(1) for x in carry[k]])
            out[k.replace("ghost_", "ghost_rows_")] = int(total[0].item())
        return out


register_distributed(
    "locking", DistributedLockingEngine, extras=("max_pending",))
