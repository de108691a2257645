"""Bootstrap a cost model from microbenchmarks: ``python -m
repro_torch.profile.calibrate [--smoke] [--device cpu]``.

The port of ``repro.profile.calibrate``.  For every bucket width ``W``
of a Zipf graph's ladder, windows of ``B`` vertices are drawn from that
bucket's rows (so ``window_bucket`` resolves the batch path to exactly
``W``), and one whole ``apply_batch`` — gather, ``ell_spmv`` launch,
update, write-back, bookkeeping — is timed per ``(W, B)`` point.  One
full bucket sweep is recorded as a ``step`` (for checking the model's
``predict_launches``, not a fit point), and the per-row sync cost is the
slope of a row scatter (``index_copy_`` into ``[nv, 4]`` float32) at
``nv // 8`` and ``nv // 2`` rows.

Timing statistic: best of ``iters`` calls of ``time.perf_counter``
wall time, with ``torch.cuda.synchronize()`` before and after each call
on the card.  Not CUDA events: the dispatch choice trades whole
``apply_batch`` wall times, the host's launches and ``window_bucket``'s
``.item()`` included, and the window engines' card idles most of a
superstep.  One untimed call first absorbs the first launch's build of
the kernel with nvcc.  The reference can attach XLA HLO op counts to
each record (``--no-hlo`` turns that off); the port has no HLO, so its
records carry no ``"hlo"`` key.

Writes ``results/torch/TRACE_<device>.json`` and fits and writes
``results/torch/COSTMODEL_<device>.json`` (``$REPRO_TORCH_RESULTS_DIR``
overrides the directory).  ``--device`` defaults to the GPU and is the
only option the reference's CLI lacks.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.profile.model import CostModel, fit_cost_model
from repro_torch.profile.trace import TraceRecorder

SMOKE_SIZES = dict(nv=400, cap=32, batch_sizes=(4, 16, 64), iters=3)
FULL_SIZES = dict(nv=10_000, cap=192, batch_sizes=(8, 64, 512, 4096),
                  iters=5)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_us(fn, *args, device: torch.device, warmup: int = 1,
             iters: int = 5) -> float:
    """Best-of-``iters`` wall microseconds, the device drained before
    and after each call."""
    for _ in range(warmup):
        fn(*args)
    best = float("inf")
    for _ in range(iters):
        _synchronize(device)
        t0 = time.perf_counter()
        fn(*args)
        _synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _batch_fn(g, upd, ids, mode: str):
    """One conflict-free batch over ``ids`` (every vertex active), the
    launch shape forced to ``mode``."""
    from repro_torch.core.exec import apply_batch
    nv, dev = g.n_vertices, g.device
    valid = torch.ones(ids.shape, dtype=torch.bool, device=dev)

    def run(vdata):
        carry = (vdata, g.edge_data,
                 torch.ones((nv,), dtype=torch.bool, device=dev),
                 torch.ones((nv,), dtype=torch.float32, device=dev),
                 torch.zeros((), dtype=torch.int64, device=dev))
        out = apply_batch(g, upd, carry, ids, valid, {}, use_kernel=True,
                          dispatch=mode)
        return out[0]
    return run


def _bucket_windows(ell, b: int, batch_sizes, seed: int):
    """Sorted id windows drawn from bucket ``b``'s owned rows (with
    replacement past the bucket's row count, so every ``B`` is
    reachable); all-bucket-``b`` windows pin the batch path's
    ``window_bucket`` to width ``widths[b]``.  The draws are the
    reference's: the same numpy generator and seed."""
    s, e = int(ell.starts[b]), int(ell.starts[b + 1])
    rows = ell.perm[s:e].cpu().numpy()
    if ell.is_split:
        rows = rows[rows < ell.n_virtual]
        rows = ell.owner_of_vrow.cpu().numpy()[rows]
    owners = np.unique(rows[rows < ell.n_rows])
    if owners.size == 0:
        return []
    rng = np.random.default_rng(seed + b)
    out = []
    for B in batch_sizes:
        pick = (rng.choice(owners, size=B, replace=B > owners.size)
                if B != owners.size else owners)
        out.append((B, torch.from_numpy(np.sort(pick).astype(np.int32))
                    .to(ell.device)))
    return out


def _measure_sync(nv: int, recorder: TraceRecorder, iters: int,
                  device: torch.device) -> None:
    """Per-row sync cost: a row scatter at two sizes."""
    arr = torch.zeros((nv, 4), dtype=torch.float32, device=device)
    for rows in sorted({max(nv // 8, 1), max(nv // 2, 2)}):
        idx = torch.arange(rows, device=device)
        vals = torch.ones((rows, 4), dtype=torch.float32, device=device)
        wall = _time_us(arr.index_copy_, 0, idx, vals, device=device,
                        iters=iters)
        recorder.record_sync(rows=rows, wall_us=wall)


def calibrate_graph(g, batch_sizes, iters: int = 5, seed: int = 0,
                    emit=print) -> tuple[TraceRecorder, CostModel]:
    """Record the microbenchmark trace on PageRank graph ``g`` (on its
    own device) and fit a model (callers decide whether to persist)."""
    from repro_torch.apps import pagerank
    device = g.device
    upd = pagerank.make_update(1e-6)
    ell = g.ell
    recorder = TraceRecorder(device=device.type)
    for b, w in enumerate(ell.widths):
        for B, ids in _bucket_windows(ell, b, batch_sizes, seed):
            fn = _batch_fn(g, upd, ids, "batch")
            wall = _time_us(fn, g.vertex_data, device=device, iters=iters)
            recorder.record_launch(mode="batch", width=w, rows=B,
                                   wall_us=wall)
            emit(f"calibrate_w{w}_B{B},{wall:.1f},slots={B * w}")
    # one full bucket sweep for checking predictions (not a fit point)
    ids_all = torch.arange(g.n_vertices, dtype=torch.int32, device=device)
    fn = _batch_fn(g, upd, ids_all, "bucket")
    recorder.record_step(mode="bucket", wall_us=_time_us(
        fn, g.vertex_data, device=device, iters=iters),
        launches=ell.bucket_launches)
    _measure_sync(g.n_vertices, recorder, iters, device)
    model = fit_cost_model(recorder.records, device=recorder.device)
    return recorder, model


def calibrate(nv: int, cap: int, batch_sizes, iters: int = 5,
              seed: int = 0, emit=print,
              device=None) -> tuple[TraceRecorder, CostModel]:
    """``calibrate_graph`` on PageRank's graph over ``zipf_edges(nv,
    alpha=2.0, max_deg=cap, seed=seed)``.  ``device`` defaults to the
    GPU."""
    from repro_torch.apps import pagerank
    from repro_torch.core.graph import zipf_edges
    g = pagerank.make_graph(zipf_edges(nv, alpha=2.0, max_deg=cap,
                                       seed=seed), nv,
                            device=resolve_device(device))
    return calibrate_graph(g, batch_sizes, iters=iters, seed=seed, emit=emit)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="record a launch-cost trace and fit "
                    "results/torch/COSTMODEL_<device>.json")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes for CI (seconds, not minutes)")
    ap.add_argument("--nv", type=int, default=None)
    ap.add_argument("--cap", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)
    sizes = dict(SMOKE_SIZES if args.smoke else FULL_SIZES)
    for key in ("nv", "cap", "iters"):
        if getattr(args, key) is not None:
            sizes[key] = getattr(args, key)
    recorder, model = calibrate(seed=args.seed, device=args.device, **sizes)
    tpath = recorder.save()
    mpath = model.save()
    print(f"# {len(recorder.records)} records -> {tpath}")
    print(f"# fitted {len(model.coef)} widths, "
          f"sync={model.sync_cost_us:.4f} us/row -> {mpath}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
