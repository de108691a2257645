#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. build    — compile every CUDA source of the port with nvcc;
2. kernels  — each kernel against its plain PyTorch version on the card,
              at the main path's full-size shapes (every degree bucket of
              the 2,097,152-vertex Zipf graph at F=1, one ``ell_fold``
              shape, F=32, bf16): float32 bitwise, bf16 within 2e-2; with
              CUDA-event times beside the plain version, one library call
              (``torch.sparse.mm`` on the same matrix in CSR) and the
              least time the card could take (the bound);
3. parity   — PageRank on the 2,000-vertex Zipf graph through
              ``api.run``, on the GPU and on the CPU: ranks, counts and
              syncs bitwise equal; kernel arm == dense arm on the GPU;
4. main     — PageRank to convergence (eps=1e-4) on the full-size graph
              through ``api.run``, with the launch counts set to 0 just
              before and read just after; the fixed point, the top-2 and
              total-rank syncs checked against float64 on the host;
5. report   — a ``{"kernels": [...]}`` line, then the contract line
              ``{"ok": true, "device": {...}}`` last.

Needs one CUDA GPU and the repository's ``src/`` beside this file.
"""
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
FULL_N = 2 ** 21
EPS = 1e-4
L2_FLUSH_BYTES = 128 << 20     # > the 50 MB L2: launches are timed cold


def cuda_device(torch):
    return torch.device("cuda", torch.cuda.current_device())


def log(msg=""):
    print(msg, flush=True)


def _event_ms(torch, fn, reps, flush, sleep_cycles):
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def time_cuda(torch, fn, reps, flush):
    """``(device_ms, call_ms)`` of ``fn``: CUDA-event times, each launch
    after an L2 flush (so it starts cold, as a bucket launch does in a
    superstep), averaged over ``reps`` after two untimed calls.
    ``call_ms`` includes the host's time to enqueue the call (the
    wrapper's checks and the launch); for ``device_ms`` the stream first
    spins long enough for the host to enqueue the whole call, so the
    events bracket only the device's execution."""
    fn()
    fn()
    torch.cuda.synchronize()
    call = _event_ms(torch, fn, reps, flush, 0)
    # ~2 GHz: spin for twice the host-inclusive time, at least 0.1 ms
    device = _event_ms(torch, fn, reps, flush,
                       int(4e6 * max(call, 0.1)))
    return device, call


def touched_rows(torch, nbrs, real=None):
    """Distinct rows of x that the real slots of ``nbrs`` read: the
    part of x this call's data needs."""
    return int(torch.unique(nbrs if real is None else nbrs[real]).numel())


def bound_ms(nv, width, rows, feat, elt, mask_bytes):
    """Least time for one ell_spmv call: the larger of the bytes it must
    move (nbrs, w, the ``rows`` rows of x it reads and the row mask read
    once, y written once) over the HBM rate and its flops (one mul for
    the mask gate, one mul and one add per slot and feature) over the
    float32 rate."""
    nbytes = (nv * width * (4 + elt) + rows * feat * elt + mask_bytes
              + nv * feat * elt)
    flops = nv * width * (1 + 2 * feat)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gathered_bound_ms(nv, width, feat):
    """The bound counting every gathered row of x as read from HBM:
    (Nv*W*(4+4) + Nv*W*4*F + Nv*F*4) / 3.35 TB/s."""
    return 1e3 * (nv * width * 8 + nv * width * 4 * feat
                  + nv * feat * 4) / HBM_BYTES_PER_S


def csr_of(torch, nbrs, w, real, row_mask, n_cols):
    """The block's matrix in CSR (real slots only, columns sorted),
    the input of the library yardstick."""
    nv, width = nbrs.shape
    rows = torch.arange(nv, device=nbrs.device)[:, None].expand(nv, width)
    key = (rows[real] * n_cols + nbrs[real].long())
    order = torch.argsort(key)
    vals = (w * row_mask.to(w.dtype)[:, None])[real][order]
    cols = nbrs[real].long()[order]
    crow = torch.zeros(nv + 1, dtype=torch.int64, device=nbrs.device)
    crow[1:] = torch.cumsum(real.sum(dim=1), 0)
    return torch.sparse_csr_tensor(crow, cols, vals, size=(nv, n_cols))


def phase_kernels(torch, ctx):
    """Kernel vs plain version at the main path's shapes."""
    from repro_torch.kernels.ell_spmv import ell_fold, ell_spmv, ell_spmv_plain
    dev = ctx["dev"]
    graph = ctx["graph"]
    ell = graph.ell
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    n = graph.n_vertices
    x = torch.rand((n, 1), generator=gen, device=dev) + 0.5
    w_edge = graph.edge_data["w"]
    rows_out, errs = [], []
    tot = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, bound_ms=0.0,
               library_ms=0.0)
    bound_by = set()
    log("times: device ms (call ms with the host's enqueue), L2 flushed")
    log(f"{'bucket':>6} {'Nv_b':>9} {'W_b':>4} {'ms':>9} {'call':>8} "
        f"{'plain_ms':>9} {'lib_ms':>9} {'lib_call':>8} {'bound_ms':>9} "
        f"{'gath_bound':>10} {'mismatch':>8}")
    for b, (width, nv) in enumerate(ell.bucket_launches):
        nbrs = ell.nbrs[b]
        real = ell.nbr_mask[b]
        w = torch.where(real, w_edge[ell.edge_ids[b].long()], 0.0).contiguous()
        mask = torch.rand(nv, generator=gen, device=dev) < 0.8
        args = (nbrs, w, x, mask)
        y = ell_spmv(*args)
        yp = ell_spmv_plain(*args)
        torch.cuda.synchronize()
        mism = int((y != yp).sum())
        err = float((y - yp).abs().max()) if nv else 0.0
        errs.append(err)
        if mism:
            raise AssertionError(f"bucket {b}: {mism} f32 elements differ "
                                 f"from the plain version (max {err})")
        csr = csr_of(torch, nbrs, w, real, mask, n)
        ylib = torch.sparse.mm(csr, x)
        lib_err = float((ylib - y).abs().max())
        ms, call_ms = time_cuda(torch, lambda: ell_spmv(*args), 20, flush)
        plain_ms, _ = time_cuda(torch, lambda: ell_spmv_plain(*args), 3,
                                flush)
        lib_ms, lib_call = time_cuda(torch, lambda: torch.sparse.mm(csr, x),
                                     20, flush)
        bms, by = bound_ms(nv, width, touched_rows(torch, nbrs, real), 1, 4,
                           nv)
        bound_by.add(by)
        gms = gathered_bound_ms(nv, width, 1)
        log(f"{b:>6} {nv:>9} {width:>4} {ms:>9.4f} {call_ms:>8.4f} "
            f"{plain_ms:>9.4f} {lib_ms:>9.4f} {lib_call:>8.4f} {bms:>9.4f} "
            f"{gms:>10.4f} {mism:>8}   (library max |diff| {lib_err:.2e})")
        rows_out.append(dict(bucket=b, nv=nv, width=width, ms=ms,
                             call_ms=call_ms, plain_ms=plain_ms,
                             library_ms=lib_ms,
                             bound_ms=bms, gathered_bound_ms=gms,
                             mismatches=mism))
        tot["ms"] += ms
        tot["call_ms"] += call_ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += bms
        tot["library_ms"] += lib_ms
    log(f"one bucket sweep (sum over buckets): kernel {tot['ms']:.4f} ms "
        f"({tot['call_ms']:.4f} ms with the host), "
        f"plain {tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} "
        f"ms, bound {tot['bound_ms']:.4f} ms ({'/'.join(sorted(bound_by))})")

    # ell_fold at the dense arm's shape for the bucket with most slots
    b = max(range(ell.n_buckets), key=lambda i: ell.bucket_launches[i][0]
            * ell.bucket_launches[i][1])
    width, nv = ell.bucket_launches[b]
    wf = torch.rand((nv, width), generator=gen, device=dev)
    vals = torch.rand((nv, width, 1), generator=gen, device=dev)
    mask = torch.rand(nv, generator=gen, device=dev) < 0.8
    idx = (torch.arange(nv, dtype=torch.int32, device=dev)[:, None] * width
           + torch.arange(width, dtype=torch.int32, device=dev))
    yk = ell_fold(wf, vals, mask)
    yp = ell_spmv_plain(idx, wf, vals.reshape(-1, 1), mask)
    torch.cuda.synchronize()
    mism = int((yk != yp).sum())
    if mism:
        raise AssertionError(f"ell_fold: {mism} elements differ")
    fold_ms, _ = time_cuda(torch, lambda: ell_fold(wf, vals, mask), 20,
                           flush)
    log(f"ell_fold [{nv}, {width}, 1]: {fold_ms:.4f} ms, mismatches 0, "
        f"bound {bound_ms(nv, width, nv * width, 1, 4, nv)[0]:.4f} ms")

    # wide features, float32 and bfloat16
    for dtype, feat in ((torch.float32, 32), (torch.bfloat16, 1),
                        (torch.bfloat16, 32)):
        nv, width, rows = 1 << 20, 8, 1 << 20
        nbrs = torch.randint(0, rows, (nv, width), generator=gen, device=dev,
                             dtype=torch.int32)
        w = torch.rand((nv, width), generator=gen, device=dev).to(dtype)
        xs = torch.randn((rows, feat), generator=gen, device=dev).to(dtype)
        mask = torch.rand(nv, generator=gen, device=dev) < 0.8
        y = ell_spmv(nbrs, w, xs, mask)
        yp = ell_spmv_plain(nbrs, w, xs, mask)
        torch.cuda.synchronize()
        mism = int((y != yp).sum())
        err = float((y.float() - yp.float()).abs().max())
        if dtype == torch.float32 and mism:
            raise AssertionError(f"F={feat} f32: {mism} elements differ")
        if dtype == torch.bfloat16:
            torch.testing.assert_close(y.float(), yp.float(), rtol=2e-2,
                                       atol=2e-2)
        ms, _ = time_cuda(torch, lambda: ell_spmv(nbrs, w, xs, mask), 20,
                          flush)
        elt = 2 if dtype == torch.bfloat16 else 4
        bms = bound_ms(nv, width, touched_rows(torch, nbrs), feat, elt, nv)[0]
        log(f"ell_spmv [{nv}, {width}] F={feat} {str(dtype)[6:]}: {ms:.4f} "
            f"ms, bound {bms:.4f} ms, mismatches {mism}, max |diff| "
            f"{err:.2e}")
    ctx["kernel_rows"] = rows_out
    tot["bound_by"] = "/".join(sorted(bound_by))
    ctx["kernel_totals"] = tot
    ctx["kernel_max_err"] = max(errs)


def phase_parity(torch, ctx):
    """The 2k Zipf PageRank: GPU == CPU and kernel == dense, bitwise."""
    from repro_torch import api
    from repro_torch.apps import pagerank
    from repro_torch.core.graph import zipf_edges
    from repro_torch.kernels.ell_spmv import ell_spmv
    edges = zipf_edges(2000, alpha=2.0, max_deg=64, seed=1)
    g, upd, syncs = pagerank.build(edges, 2000, eps=EPS, device="cpu")
    cpu = api.run(g, upd, syncs=syncs, device="cpu")
    before = ell_spmv.launches
    gpu = api.run(g, upd, syncs=syncs, device=ctx["dev"])
    launched = ell_spmv.launches - before
    dense = api.run(g, upd, syncs=syncs, device=ctx["dev"], use_kernel=False)

    def same(a, b):
        ra, rb = a.vertex_data["rank"].cpu(), b.vertex_data["rank"].cpu()
        glob = all(torch.equal(x.cpu(), y.cpu())
                   for k in a.globals
                   for x, y in zip(*(v if isinstance(v, tuple) else (v,)
                                     for v in (a.globals[k], b.globals[k]))))
        return (torch.equal(ra, rb) and glob and
                (a.superstep, a.n_updates) == (b.superstep, b.n_updates))

    log(f"2k Zipf: cpu {cpu.superstep} supersteps / {cpu.n_updates} updates,"
        f" gpu {gpu.superstep} / {gpu.n_updates}, dense {dense.superstep} /"
        f" {dense.n_updates}; kernel launches {launched}")
    if not same(gpu, cpu):
        diff = int((gpu.vertex_data["rank"].cpu()
                    != cpu.vertex_data["rank"]).sum())
        raise AssertionError(f"GPU run != CPU run ({diff} ranks differ)")
    if not same(gpu, dense):
        raise AssertionError("kernel arm != dense arm on the GPU")
    if launched <= 0:
        raise AssertionError("the kernel arm never launched ell_spmv")
    log("2k Zipf: GPU == CPU bitwise, kernel == dense bitwise")


def layer_breakdown(torch, engine):
    """Seconds per layer of one fresh superstep, each layer bracketed
    by synchronizes (so layers do not overlap; the sum is a little more
    than an unbracketed superstep)."""
    import repro_torch.core.exec as ex
    from repro_torch.core.graph import SlicedEll
    acc = {}

    def timed(name, fn):
        def inner(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
            return out
        return inner

    names = ["gather_scopes", "route_batch_to_buckets", "ell_spmv_bucketed",
             "_owner_rows", "scatter_result", "consume_and_reschedule",
             "refresh_syncs"]
    saved = {k: getattr(ex, k) for k in names}
    saved_act = SlicedEll.row_activation
    try:
        for k in names:
            setattr(ex, k, timed(k, saved[k]))
        SlicedEll.row_activation = timed("row_activation", saved_act)
        state = engine.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._superstep(state)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for k in names:
            setattr(ex, k, saved[k])
        SlicedEll.row_activation = saved_act
    acc["other (combine, select, host)"] = total - sum(acc.values())
    return total, acc


def device_busy(torch, engine):
    """Wall time and summed device time of one fresh superstep under
    torch.profiler; None where the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    state = engine.init_state()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine._superstep(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0],
                                                "self_device_time_total")
            else "self_cuda_time_total")
    # device-side events only: an operator's row repeats its kernels' time
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    per = sorted(((getattr(e, attr), e.key) for e in kern), reverse=True)
    busy_us = sum(t for t, _ in per)
    return wall, (busy_us * 1e-6 if busy_us > 0 else None), per[:10]


def phase_main(torch, ctx):
    """The full-size PageRank through api.run, counted and checked."""
    import numpy as np

    from repro_torch import api
    from repro_torch.apps import pagerank
    from repro_torch.kernels.ell_spmv import ell_spmv
    g, upd, syncs = ctx["graph"], ctx["update"], ctx["syncs"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ell_spmv.launches = 0
    t0 = time.perf_counter()
    res = api.run(g, upd, syncs=syncs, device=ctx["dev"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ell_spmv.launches
    peak = torch.cuda.max_memory_allocated()
    ctx["launches"] = {"ell_spmv": launches}
    log(f"full size: converged={not res.active_any} in {res.superstep} "
        f"supersteps, {res.n_updates} updates, {wall:.3f} s "
        f"({1e3 * wall / max(res.superstep, 1):.2f} ms/superstep), "
        f"ell_spmv launches {launches} "
        f"({launches / max(res.superstep, 1):.0f}/superstep), "
        f"peak device memory {peak / 2**30:.2f} GiB")
    if res.active_any:
        raise AssertionError("PageRank did not converge within 100 supersteps")
    if launches <= 0:
        raise AssertionError("the main path never launched ell_spmv")

    r = res.vertex_data["rank"].cpu().numpy().astype(np.float64)
    wr = pagerank.sparse_matvec(ctx["edges"], g.n_vertices, r)
    resid = float(np.abs(r - (pagerank.ALPHA
                              + (1 - pagerank.ALPHA) * wr)).max())
    top2 = float(res.globals["top2"][0])
    second = float(np.partition(r, -2)[-2])
    total = float(res.globals["total_rank"])
    rel = abs(total - r.sum()) / r.sum()
    log(f"full size: fixed-point residual {resid:.3e} (limit {100 * EPS:.0e})"
        f", top2 {top2} vs host {second}, total_rank {total} vs float64 "
        f"{r.sum():.6f} (rel {rel:.2e})")
    if not np.isfinite(r).all() or r.shape != (g.n_vertices,):
        raise AssertionError("ranks are not finite or have the wrong shape")
    if resid >= 100 * EPS:
        raise AssertionError(f"fixed-point residual {resid} >= {100 * EPS}")
    if top2 != second:
        raise AssertionError(f"top2 sync {top2} != host {second}")
    if rel >= 1e-4:
        raise AssertionError(f"total_rank off by {rel} relative")

    engine = res.engine
    total_s, layers = layer_breakdown(torch, engine)
    log(f"one fresh superstep, layers bracketed by synchronize: "
        f"{1e3 * total_s:.2f} ms")
    for k, v in sorted(layers.items(), key=lambda kv: -kv[1]):
        log(f"  {k:<32} {1e3 * v:9.2f} ms  {100 * v / total_s:5.1f}%")
    try:
        wall_s, busy_s, top = device_busy(torch, engine)
    except Exception:            # the profiler is optional here
        traceback.print_exc()
        wall_s, busy_s, top = None, None, []
    if busy_s is None:
        log("device idle share: not measured (no device time in the trace)")
    else:
        log(f"one fresh superstep under torch.profiler: wall "
            f"{1e3 * wall_s:.2f} ms, device busy {1e3 * busy_s:.2f} ms, "
            f"idle share {max(0.0, 1 - busy_s / wall_s):.3f}")
        for t, name in top:
            log(f"  {t / 1e3:9.2f} ms  {name[:70]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"FAIL: no src/repro_torch beside {Path(__file__).name}: run it "
            "from a checkout of the repository")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        smi = f"nvidia-smi failed: {exc}"
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import _build
    dev = cuda_device(torch)
    ctx = {"dev": dev}
    failed = []

    t0 = time.perf_counter()
    try:
        logs = _build.build(["ell_spmv"])
        log(f"phase 1 build: {time.perf_counter() - t0:.1f} s")
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")
    except Exception:
        traceback.print_exc()
        log("FAIL: phase 1 build")
        return 1

    from repro_torch.apps import pagerank
    from repro_torch.core.graph import zipf_edges
    t0 = time.perf_counter()
    edges = zipf_edges(FULL_N, alpha=2.0, max_deg=256, seed=0)
    t1 = time.perf_counter()
    graph, update, syncs = pagerank.build(edges, FULL_N, eps=EPS, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sizes = [int((graph.colors == c).sum()) for c in range(graph.n_colors)]
    log(f"full-size graph: {FULL_N} vertices, {len(edges)} edges, "
        f"{graph.n_colors} colors (largest {max(sizes)}), "
        f"{graph.ell.padded_slots} sliced slots, widths {graph.ell.widths}; "
        f"host set-up: edges {t1 - t0:.1f} s, build + coloring "
        f"{t2 - t1:.1f} s")
    ctx.update(graph=graph, update=update, syncs=syncs, edges=edges)

    for name, fn in (("phase 2 kernels", phase_kernels),
                     ("phase 3 parity", phase_parity),
                     ("phase 4 main path", phase_main)):
        log(f"--- {name}")
        t0 = time.perf_counter()
        try:
            fn(torch, ctx)
            log(f"{name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            log(f"FAIL: {name}")
            failed.append(name)
    if failed:
        log(f"FAILED: {failed}")
        return 1

    tot = ctx["kernel_totals"]
    kernels = [{
        "name": "ell_spmv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ell_spmv.cu",
        "replaces": "src/repro/kernels/ell_spmv.py:48",
        "launches": ctx["launches"]["ell_spmv"],
        "max_abs_err": ctx["kernel_max_err"],
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
        "library_ms": tot["library_ms"],
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
