#!/usr/bin/env python3
"""Time ``segment_combine`` (B2) at the shapes ``chip_smoke.py`` gives it,
under several builds of the kernel, on one GPU.

    python3 tools/segment_combine_sweep.py [--geometries 'default;SEG_PAIRS=4'] \\
        [--baseline OLD.cu] [--floor] [--no-shard] [--json PATH]

A geometry is ``default`` or comma-separated ``NAME=VALUE`` macros of
``csrc/segment_combine.cu`` (``SEG_THREADS``, ``SEG_PAIRS``,
``SEG_TILE_BYTES``, ``SEG_STAGE_BYTES``, ``SEG_MAX_STAGES``,
``SEG_BLOCKS_PER_SM``, ``SEG_UNROLL``, ``SEG_LOOKAHEAD``), built with
``-D`` flags under a name of its own; the wrapper plans each build's launches from the geometry the
build reports.  ``--baseline`` builds a ``segment_combine.cu`` of the
one-thread-a-(segment, feature) interface, ``segment_sum_launch(x,
offsets, offsets_64, y, n_rows, n_feat, n_src, dtype, stream)`` (the
first design: ``git show 27e8ef1:src/repro_torch/kernels/csrc/segment_combine.cu
> build/segment_combine_first.cu``; ``build/`` is git-ignored).  ``--floor``
adds the default build with its adds from shared memory taken out (the
result is not the sum and is not checked): the staging alone.

The shapes: phase 14's owner combines of the Zipf graph split at w_cap
64 and 16 (F = 1 and 32) and its window chunk combines, phase 17's owner
combine at w_cap 4, phase 18's owner combine of shard 0 of eight
(``--no-shard`` skips the partition and the plan, ~30 s of host time),
the MapReduce ALS reduces (``[Ne, d * d]`` and ``[Ne, d]`` into movies
and users) and two stress cases, one segment of 5,000 rows at F = 4 and
one of 2^20 rows at F = 1.  Every contender is checked bitwise against
the plain version (the host's serial sum for the 2^20-row segment) at
every shape, then timed after an L2 flush, the contenders in turns,
first to last and back again, each after ``chip_smoke``'s flush (128 MB
zeroed, which leaves the L2 full of dirty lines to write back during the
launch) and after a flush that reads 128 MB (a cold, clean L2).  Prints
ms per shape beside ``index_add_`` and the bound
(``chip_smoke.segment_bound``) and, with ``--json PATH``, writes every
time there.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from ell_spmv_sweep import build_all  # noqa: E402  (tools/ is on the path)


def floor_source(build):
    """A copy of ``segment_combine.cu`` (under the git-ignored build
    directory) whose pairs add nothing from shared memory: its time is
    that of staging, the ring's barriers and the stores alone."""
    src = (build.CSRC / "segment_combine.cu").read_text()
    call = "  if (n >= SEG_UNROLL) return add_rows<T>(acc, p, stride, n);\n"
    if call not in src:
        raise RuntimeError("segment_combine.cu no longer has the add this "
                           "floor build takes out")
    out = build.BUILD_DIR / "sweep" / "segment_combine_floor.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src.replace(call, "  return acc;\n"))
    return out


def baseline_fn(torch, lib, y, offsets):
    """One launch of the one-thread-a-(segment, feature) kernel."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.segment_sum_launch.argtypes = [p, p, i32, p, i64, i64, i64, i32, p]
    lib.segment_sum_launch.restype = ctypes.c_int
    n_rows = offsets.numel() - 1
    feat = y[0].numel() if y.shape[0] else 1
    out = torch.empty((n_rows,) + tuple(y.shape[1:]), dtype=y.dtype,
                      device=y.device)

    def run():
        err = lib.segment_sum_launch(
            y.data_ptr(), offsets.data_ptr(),
            int(offsets.dtype == torch.int64), out.data_ptr(), n_rows, feat,
            y.shape[0], 0 if y.dtype == torch.float32 else 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline launch failed: {err}")
        return out
    return run


class ReadFlush:
    """A flush for ``chip_smoke.time_cuda`` that reads 128 MB instead of
    zeroing it: the launch starts with a cold L2 that holds no dirty
    lines, so no write-back of the flush shares the memory bus with it."""

    def __init__(self, torch, dev, nbytes):
        self.buf = torch.ones(nbytes // 4, dtype=torch.float32, device=dev)

    def zero_(self):
        self.buf.sum()


def shapes(torch, dev, gen, shard):
    """``(label, y, offsets, reps)`` of every B2 shape on the main path."""
    import chip_smoke as cs
    from repro_torch.apps import als, pagerank
    from repro_torch.baselines import mapreduce as mr
    from repro_torch.core.graph import zipf_edges
    edges = zipf_edges(cs.FULL_N, alpha=2.0, max_deg=256, seed=0)
    out = []
    split64 = None
    for cap in (None, 16, 4):
        g, _, _ = pagerank.build(edges, cs.FULL_N, eps=cs.EPS, hub_split=True,
                                 w_cap=cap, device=dev)
        ell = g.ell
        for feat in ((1, 32) if cap != 4 else (1,)):
            out.append((f"owner combine w_cap={ell.w_cap} F={feat}",
                        torch.rand((ell.n_virtual, feat), generator=gen,
                                   device=dev), ell.vrow_offset, 20))
            if cap == 4:
                continue
            s = ell.scope_widths[-1] // ell.w_cap
            out.append((f"window chunk combine w_cap={ell.w_cap} s={s} "
                        f"F={feat}",
                        torch.rand((cs.WINDOW * s, feat), generator=gen,
                                   device=dev),
                        torch.arange(cs.WINDOW + 1, device=dev) * s, 20))
        if cap is None:
            split64 = g
        else:
            del g
    if shard:
        from repro_torch.core.distributed import ShardPlan
        from repro_torch.core.partition import two_phase_partition
        asg = two_phase_partition(cs.FULL_N, split64.edges_np, cs.N_SHARDS,
                                  seed=0)
        ell0 = ShardPlan.build(split64, asg, cs.N_SHARDS).local_ell(0, dev)
        out.append((f"shard 0's owner combine (M={cs.N_SHARDS}) F=1",
                    torch.rand((ell0.n_virtual, 1), generator=gen,
                               device=dev), ell0.vrow_offset, 20))
    del split64
    prob = als.synthetic_netflix(cs.ALS_USERS, cs.NETFLIX_MOVIES, d=cs.ALS_D,
                                 density=cs.ALS_DENSITY, noise=cs.ALS_NOISE,
                                 seed=0, device=dev)
    d = prob.d
    w = prob.graph.vertex_data["w"]
    for (shuffle, r), w_src, side in zip(mr.als_jobs(prob, dev),
                                         (w[:prob.n_users], w[prob.n_users:]),
                                         ("movies", "users")):
        msg = w_src.index_select(0, shuffle.src)
        out.append((f"MapReduce ALS reduce A to {side}",
                     (msg[:, :, None] * msg[:, None, :]).reshape(-1, d * d),
                     shuffle.offsets, 5))
        out.append((f"MapReduce ALS reduce b to {side}",
                    (msg * r[:, None]).contiguous(), shuffle.offsets, 20))
    del prob, w, msg
    for label, longest, feat in (("5,000-row segment F=4", 5000, 4),
                                 ("2^20-row segment F=1", 1 << 20, 1)):
        counts = torch.randint(0, 6, (300,), generator=gen, device=dev)
        counts[150] = longest
        offsets = torch.zeros(301, dtype=torch.int64, device=dev)
        offsets[1:] = torch.cumsum(counts, 0)
        out.append((label, torch.randn((int(offsets[-1]), feat),
                                       generator=gen, device=dev),
                    offsets, 3))
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_combine as sc
    ap = argparse.ArgumentParser()
    ap.add_argument("--geometries", default="default",
                    help="';'-separated builds: 'default' or "
                         "NAME=VALUE,... macros")
    ap.add_argument("--baseline", type=Path,
                    help="a segment_combine.cu of the one-thread-a-pair "
                         "interface, timed beside the geometries")
    ap.add_argument("--no-shard", action="store_true",
                    help="skip phase 18's shard shape")
    ap.add_argument("--floor", action="store_true",
                    help="also time the default build with its adds "
                         "taken out: the staging pipeline alone")
    ap.add_argument("--json", type=Path, help="write every time here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    dev = cs.cuda_device(torch)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    srcs = {}
    for g in filter(None, args.geometries.split(";")):
        flags = [] if g == "default" else [f"-D{kv}" for kv in g.split(",")]
        srcs[g.replace(",", "+")] = (_build.CSRC / "segment_combine.cu",
                                     flags)
    if args.floor:
        srcs["floor"] = (floor_source(_build), [])
    if args.baseline:
        srcs["baseline"] = (args.baseline, [])
    libs = build_all(srcs)
    names = list(srcs)

    gen = torch.Generator(device=dev).manual_seed(21)
    cases = shapes(torch, dev, gen, not args.no_shard)
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    clean = ReadFlush(torch, dev, cs.L2_FLUSH_BYTES)

    # each build loaded as the wrapper loads its own (argtypes, geometry)
    loaded = {}
    for name in names:
        if name != "baseline":
            sc._lib = None
            saved = _build.load
            _build.load = lambda _, lib=libs[name]: lib
            try:
                loaded[name] = sc._kernel_lib()
            finally:
                _build.load = saved
            print(f"{name}: {loaded[name].geometry}")

    def use(name, y, offsets):
        if name == "baseline":
            return baseline_fn(torch, libs[name], y, offsets)

        def run():
            sc._lib = loaded[name]
            return sc.segment_sum_csr(y, offsets)
        return run

    rows = []
    for label, y, offsets, reps in cases:
        torch.cuda.synchronize()
        long = label.startswith("2^20")
        want = (sc.segment_sum_csr_serial(y, offsets).to(dev) if long
                else sc.segment_sum_csr_plain(y, offsets))
        bound, by = cs.segment_bound(y, offsets)
        n_rows = offsets.numel() - 1
        seg = torch.repeat_interleave(
            torch.arange(n_rows, device=dev),
            (offsets[1:] - offsets[:-1]).long())
        head = y[:int(offsets[-1])]
        lib_ms = cs.time_cuda(torch, lambda: torch.zeros(
            want.shape, dtype=y.dtype, device=dev).index_add_(0, seg, head),
            reps, flush)[0]
        del seg, head
        times = {n: [] for n in names}
        clean_ms = {n: [] for n in names}
        for name in names + names[::-1]:
            fn = use(name, y, offsets)
            got = fn()
            torch.cuda.synchronize()
            if name != "floor" and cs.bits_differ(torch, got, want):
                raise AssertionError(f"{name}: {label} differs from the "
                                     "plain version")
            times[name].append(cs.time_cuda(torch, fn, reps, flush)[0])
            clean_ms[name].append(cs.time_cuda(torch, fn, reps, clean)[0])
        row = dict(label=label, rows=n_rows, src=y.shape[0],
                   feat=y[0].numel(), dtype=str(y.dtype)[6:],
                   offsets=str(offsets.dtype)[6:], bound_ms=bound,
                   bound_by=by, library_ms=lib_ms, ms=times,
                   clean_flush_ms=clean_ms)
        rows.append(row)
        print(f"{label}: [{y.shape[0]}, {row['feat']}] into {n_rows}; bound "
              f"{bound:.4f} ({by}), index_add_ {lib_ms:.4f}; "
              + "; ".join(f"{n} {t[0]:.4f}/{t[1]:.4f} "
                          f"({min(t) / bound:.2f}x; clean flush "
                          f"{min(clean_ms[n]):.4f})"
                          for n, t in times.items()), flush=True)
        del want, y
    print("ms, the lesser of two runs each, after chip_smoke's flush "
          "(zeroing 128 MB) / after reading 128 MB:")
    print(f"{'shape':<46} {'bound':>8} {'index_add_':>10} "
          + " ".join(f"{n[:18]:>18}" for n in names))
    for r in rows:
        print(f"{r['label'][:46]:<46} {r['bound_ms']:>8.4f} "
              f"{r['library_ms']:>10.4f} "
              + " ".join(f"{min(r['ms'][n]):>8.4f}/"
                         f"{min(r['clean_flush_ms'][n]):<9.4f}"
                         for n in names))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
