"""Loopy Belief Propagation + GMM co-segmentation (paper §5.2, CoSeg),
on the port.

The port of ``repro.apps.lbp``.  3-D grid data graph (frames x height x
width of super-pixels).  Vertex data: super-pixel features, unary
log-potentials, the current belief.  Edge data: the two directed
messages of sum-product BP in log domain (``msg01``: endpoint 0 ->
endpoint 1, ``msg10`` reverse).  The update is the residual-BP local
iteration: recompute the outgoing messages from the cavity belief under
a Potts potential, reschedule a neighbour whose incoming message moved
by more than ``eps``, with the residual as its priority.  A sync keeps
the GMM centroids, which the update reads back for its unary terms.
``frame_partition`` (the paper's natural cut across frames) and
``striped_partition`` (its worst case) feed the distributed engines.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.coloring import greedy_coloring
from repro_torch.core.graph import DataGraph, grid_edges_3d
from repro_torch.core.registry import get_scheduler
from repro_torch.core.sync import SyncOp
from repro_torch.core.update import (Consistency, ScopeBatch, UpdateFn,
                                     UpdateResult)


def make_update(n_labels: int, beta: float = 1.0, gamma: float = 2.0,
                eps: float = 1e-2, use_gmm_sync: bool = True) -> UpdateFn:
    log_psi = -beta * (1.0 - torch.eye(n_labels))      # Potts potential
    on_device = {}

    def update(scope: ScopeBatch) -> UpdateResult:
        feat = scope.v_data["feat"]                  # [B, F]
        psi = on_device.get(feat.device)
        if psi is None:
            psi = on_device[feat.device] = log_psi.to(feat.device)
        if use_gmm_sync and "gmm" in scope.globals:
            mu = scope.globals["gmm"]                # [K, F]
            unary = -gamma * ((feat[:, None, :] - mu[None]) ** 2).sum(-1)
        else:
            unary = scope.v_data["unary"]            # [B, K]
        msg01 = scope.edge_data["msg01"]             # [B, D, K]
        msg10 = scope.edge_data["msg10"]
        src = scope.is_src[..., None]
        inc = torch.where(src, msg10, msg01)                    # into v
        old_out = torch.where(src, msg01, msg10)
        inc = torch.where(scope.nbr_mask[..., None], inc, 0.0)
        belief = unary + inc.sum(dim=1)                         # [B, K]
        cavity = belief[:, None, :] - inc                       # [B, D, K]
        # m_vu(x_u) = logsumexp_xv cavity(x_v) + log_psi(x_v, x_u)
        new_out = torch.logsumexp(
            cavity[..., :, None] + psi[None, None], dim=2)      # [B, D, K]
        new_out = new_out - torch.logsumexp(new_out, dim=-1, keepdim=True)
        residual = torch.where(
            scope.nbr_mask, (new_out - old_out).abs().amax(dim=-1), 0.0)
        out01 = torch.where(src, new_out, msg01)
        out10 = torch.where(src, msg10, new_out)
        belief = belief - torch.logsumexp(belief, dim=-1, keepdim=True)
        return UpdateResult(
            v_data={"feat": feat, "unary": unary, "belief": belief},
            edge_data={"msg01": out01, "msg10": out10},
            resched_nbrs=residual > eps,
            priority=residual.amax(dim=1),
        )
    return UpdateFn(update, Consistency.EDGE, name="lbp")


def gmm_sync(n_labels: int, n_feat: int, tau: int = 1) -> SyncOp:
    """Soft k-means M-step over beliefs — the GMM parameter sync."""
    def fold(acc, row):
        p = torch.softmax(row["belief"], dim=-1)     # [K]
        return (acc[0] + p[:, None] * row["feat"][None, :], acc[1] + p)
    return SyncOp(
        key="gmm", fold=fold,
        merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
        finalize=lambda acc: acc[0] / acc[1].clamp(min=1e-6)[:, None],
        acc0=(torch.zeros((n_labels, n_feat)), torch.zeros((n_labels,))),
        tau=tau)


@dataclasses.dataclass
class CoSegProblem:
    graph: DataGraph
    shape: tuple
    n_labels: int
    true_labels: np.ndarray
    centroids: np.ndarray


def planted_labels(n_frames: int, h: int, w: int,
                   n_labels: int) -> np.ndarray:
    """Vertical bands drifting across frames, flattened in (frame, y,
    x) order: the reference's per-pixel loop, vectorized."""
    shift = np.arange(n_frames) % max(w // n_labels, 1)
    x = np.arange(w)
    band = ((x[None, :] + shift[:, None]) * n_labels) // w % n_labels
    return np.broadcast_to(band[:, None, :], (n_frames, h, w)).reshape(-1)


def synthetic_coseg(n_frames: int, h: int, w: int, n_labels: int = 4,
                    n_feat: int = 3, noise: float = 0.4, seed: int = 0,
                    use_gmm_sync: bool = True, device=None) -> CoSegProblem:
    """Planted smooth labeling on a 3-D grid with noisy features; the
    reference's draws in its order, so a seed gives its problem."""
    rng = np.random.default_rng(seed)
    nv, edges = grid_edges_3d(n_frames, h, w)
    labels = planted_labels(n_frames, h, w, n_labels).astype(np.int64)
    centroids = rng.normal(size=(n_labels, n_feat)).astype(np.float32) * 2.0
    feat = (centroids[labels]
            + noise * rng.normal(size=(nv, n_feat))).astype(np.float32)
    gamma = 2.0
    unary = -gamma * ((feat[:, None, :] - centroids[None]) ** 2).sum(-1)
    g = DataGraph.from_edges(
        nv, edges,
        vertex_data={
            "feat": feat,
            "unary": unary.astype(np.float32),
            "belief": unary.astype(np.float32),
        },
        edge_data={
            "msg01": np.zeros((len(edges), n_labels), np.float32),
            "msg10": np.zeros((len(edges), n_labels), np.float32),
        }, device=device)
    g = g.with_colors(greedy_coloring(nv, edges))
    return CoSegProblem(g, (n_frames, h, w), n_labels, labels, centroids)


def label_accuracy(problem: CoSegProblem, vertex_data) -> float:
    """Accuracy of the beliefs' argmax (centroids keep label identity)."""
    pred = vertex_data["belief"].cpu().numpy().argmax(axis=1)
    return float((pred == problem.true_labels).mean())


def build(problem: CoSegProblem, *, beta: float = 1.0, gamma: float = 2.0,
          eps: float = 1e-2, use_gmm_sync: bool = True, tau: int = 1):
    """Uniform facade triple ``(graph, update, syncs)`` for a problem
    from ``synthetic_coseg``."""
    upd = make_update(problem.n_labels, beta=beta, gamma=gamma, eps=eps,
                      use_gmm_sync=use_gmm_sync)
    n_feat = problem.graph.vertex_data["feat"].shape[1]
    syncs = ((gmm_sync(problem.n_labels, n_feat, tau),)
             if use_gmm_sync else ())
    return problem.graph, upd, syncs


def residual_locking_engine(problem: CoSegProblem, eps: float = 1e-2,
                            max_pending: int = 64,
                            max_supersteps: int = 20000,
                            use_gmm_sync: bool = True):
    """CoSeg under the locking engine: residual-BP priorities feed the
    pending window — the paper's §5.2 adaptive prioritized schedule.
    ``max_pending`` is the lock-pipeline depth of Fig. 8(b).  The engine
    runs where the problem's graph lives."""
    graph, upd, syncs = build(problem, eps=eps, use_gmm_sync=use_gmm_sync)
    return get_scheduler("locking").factory(
        graph, upd, syncs=syncs, max_pending=max_pending,
        max_supersteps=max_supersteps)


def distributed_locking_engine(problem: CoSegProblem, n_shards: int,
                               max_pending: int = 64,
                               max_supersteps: int = 20000,
                               eps: float = 1e-2,
                               worst_case: bool = False):
    """CoSeg on ``n_shards`` shards under the distributed locking engine:
    the frame partition (or the paper's striped worst case), cut-edge
    message replicas exchanged through the versioned edge sync.  The
    shards share the device the problem's graph lives on."""
    from repro_torch import api
    asg_fn = striped_partition if worst_case else frame_partition
    upd = make_update(problem.n_labels, eps=eps, use_gmm_sync=False)
    return api.build_engine(
        problem.graph, upd, scheduler="locking", n_shards=n_shards,
        partition=asg_fn(problem, n_shards), max_pending=max_pending,
        max_supersteps=max_supersteps, exchange_edges=True,
        device=problem.graph.device)


def frame_partition(problem: CoSegProblem, n_machines: int) -> np.ndarray:
    """The paper's natural partitioning: slice across frames (§5.2)."""
    f, h, w = problem.shape
    frames = np.arange(f * h * w) // (h * w)
    return (frames * n_machines) // f


def striped_partition(problem: CoSegProblem, n_machines: int) -> np.ndarray:
    """The paper's worst-case partition: frames striped across machines
    (Fig. 8b), so every scope acquisition crosses shards."""
    f, h, w = problem.shape
    frames = np.arange(f * h * w) // (h * w)
    return frames % n_machines
