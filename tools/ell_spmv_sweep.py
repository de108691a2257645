#!/usr/bin/env python3
"""Time ``ell_spmv`` on ``chip_smoke.py``'s PageRank sweep (the
2,097,152-vertex Zipf graph's 8 degree buckets at F = 1) under several
kernel geometries, on one GPU.

    python3 tools/ell_spmv_sweep.py [--geometries '4096x256x4;2048x128x8'] \\
        [--baseline OLD.cu] [--json PATH]

A geometry ``TILExTHREADSxBLOCKS[:-DFLAG...]`` builds ``csrc/ell_spmv.cu`` with
``-DELL_TILE=TILE -DELL_THREADS=THREADS -DELL_MIN_BLOCKS=BLOCKS`` and
any further flags given after colons (the
slots a block gathers in one pass, the threads of a block, the blocks
an SM the F = 1 body is compiled to keep resident) under a name of its
own and plans the wrapper's launches for it.  Every geometry's sweep is checked
bitwise against the plain version, then timed as one launch after an L2
flush, and each bucket as a launch of its own, then phase 2's
``[2^20, 8]`` launches at F = 32 (float32) and F = 1 and 32 (bf16).  ``--baseline`` builds
an ``ell_spmv.cu`` of the one-launch-per-bucket interface (the
repository's before the one-launch table: ``ell_spmv_launch(nbrs, w,
mask, x, y, n_rows, width, n_src, n_feat, dtype, stream)`` with a mask
in w's dtype) and times its sweep as 8 launches after one flush, each
with the mask cast its wrapper made.  The contenders run in turns,
first to last and back again.  Prints a table of ms and, with ``--json
PATH``, writes every time there.  First it times ``index_select`` of
the sweep's real slots from x (PyTorch's own gather of the same
values, int32 indices): the card's rate for the random reads alone.
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


def build_all(srcs):
    """``{name: (source, extra flags)}`` -> ``{name: CDLL}``, all nvcc
    runs at once, into the kernels' git-ignored build directory."""
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, flags) in srcs.items():
        out = out_dir / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out),
               str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def baseline_fn(torch, lib, nbrs, w, x, mask):
    """One launch of the one-launch-per-bucket kernel, as its wrapper
    made it (the row mask cast to w's dtype first)."""
    p = ctypes.c_void_p
    lib.ell_spmv_launch.argtypes = [p, p, p, p, p, ctypes.c_int64,
                                    ctypes.c_int32, ctypes.c_int64,
                                    ctypes.c_int32, ctypes.c_int32, p]
    lib.ell_spmv_launch.restype = ctypes.c_int
    nv, width = nbrs.shape
    y = torch.empty((nv, x.shape[1]), dtype=x.dtype, device=x.device)

    def run():
        rm = mask.to(w.dtype)
        err = lib.ell_spmv_launch(
            nbrs.data_ptr(), w.data_ptr(), rm.data_ptr(), x.data_ptr(),
            y.data_ptr(), nv, width, x.shape[0], x.shape[1],
            0 if x.dtype == torch.float32 else 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline launch failed: {err}")
        return y
    return run


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.apps import pagerank
    from repro_torch.core.graph import zipf_edges
    from repro_torch.kernels import _build
    from repro_torch.kernels import ell_spmv as es
    ap = argparse.ArgumentParser()
    ap.add_argument("--geometries", default="4096x256x4",
                    help="';'-separated TILExTHREADSxBLOCKS builds of the "
                         "kernel")
    ap.add_argument("--baseline", type=Path,
                    help="an ell_spmv.cu of the one-launch-per-bucket "
                         "interface, timed beside the geometries")
    ap.add_argument("--json", type=Path, help="write every time here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    dev = chip_smoke.cuda_device(torch)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    srcs, plans = {}, {}
    for g in filter(None, args.geometries.split(";")):
        geom, *flags = g.split(":")
        t, n, m = (int(v) for v in geom.split("x"))
        name = f"{geom}{''.join(flags)}"
        srcs[name] = (_build.CSRC / "ell_spmv.cu",
                      [f"-DELL_TILE={t}", f"-DELL_THREADS={n}",
                       f"-DELL_MIN_BLOCKS={m}", *flags])
        plans[name] = (t, n)
    if args.baseline:
        srcs["baseline"] = (args.baseline, [])
    libs = build_all(srcs)

    edges = zipf_edges(chip_smoke.FULL_N, alpha=2.0, max_deg=256, seed=0)
    graph, _, _ = pagerank.build(edges, chip_smoke.FULL_N, eps=chip_smoke.EPS,
                                 device=dev)
    ell = graph.ell
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((graph.n_vertices, 1), generator=gen, device=dev) + 0.5
    w_edge = graph.edge_data["w"]
    nbrs_l, w_l, m_l = [], [], []
    for b in range(ell.n_buckets):
        real = ell.nbr_mask[b]
        nbrs_l.append(ell.nbrs[b])
        w_l.append(torch.where(real, w_edge[ell.edge_ids[b].long()], 0.0)
                   .contiguous())
        m_l.append(torch.rand(ell.nbrs[b].shape[0], generator=gen,
                              device=dev) < 0.8)
    want = torch.cat([es.ell_spmv_plain(*a, x, m)
                      for *a, m in zip(nbrs_l, w_l, m_l)])
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device=dev)
    # phase 2's wide-feature shapes: [2^20, 8] slots over 2^20 rows
    wide = []
    for dtype, feat in ((torch.float32, 32), (torch.bfloat16, 1),
                        (torch.bfloat16, 32)):
        nb = torch.randint(0, 1 << 20, (1 << 20, 8), generator=gen,
                           device=dev, dtype=torch.int32)
        w = torch.rand((1 << 20, 8), generator=gen, device=dev).to(dtype)
        xs = torch.randn((1 << 20, feat), generator=gen, device=dev).to(dtype)
        m = torch.rand(1 << 20, generator=gen, device=dev) < 0.8
        wide.append((f"{str(dtype)[6:]} F={feat}", (nb, w, xs, m),
                     es.ell_spmv_plain(nb, w, xs, m)))
    idx = torch.cat([nb[real] for nb, real in zip(nbrs_l, ell.nbr_mask)])
    ms = chip_smoke.time_cuda(torch, lambda: x.index_select(0, idx), 20,
                              flush)[0]
    print(f"index_select of {idx.numel()} values of x (int32 indices): "
          f"{ms:.4f} ms")

    def use(name):
        """Point the wrapper at a geometry's build; return its sweep and
        one-bucket calls."""
        if name == "baseline":
            fns = [baseline_fn(torch, libs[name], nb, w, x, m)
                   for nb, w, m in zip(nbrs_l, w_l, m_l)]
            return ((lambda: torch.cat([f() for f in fns])),
                    fns + [baseline_fn(torch, libs[name], *a)
                           for _, a, _ in wide])
        es.TILE, es.THREADS = plans[name]
        es._lib = None
        saved = _build.load
        _build.load = lambda _: libs[name]
        try:
            es._kernel_lib()
        finally:
            _build.load = saved
        return ((lambda: es.ell_spmv_bucketed(nbrs_l, w_l, x, m_l)),
                [(lambda nb=nb, w=w, m=m: es.ell_spmv(nb, w, x, m))
                 for nb, w, m in zip(nbrs_l, w_l, m_l)]
                + [(lambda a=a: es.ell_spmv(*a)) for _, a, _ in wide])

    names = list(srcs)
    runs = []
    for name in names + names[::-1]:
        sweep, one = use(name)
        got = sweep()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: the sweep differs from the plain "
                                 "version")
        for (label, _, yp), f in zip(wide, one[-len(wide):]):
            y = f()
            torch.cuda.synchronize()
            if yp.dtype == torch.float32 and not torch.equal(y, yp):
                raise AssertionError(f"{name}: {label} differs from the "
                                     "plain version")
            torch.testing.assert_close(y.float(), yp.float(), rtol=2e-2,
                                       atol=2e-2)
        ms = chip_smoke.time_cuda(torch, sweep, 20, flush)[0]
        buckets = [chip_smoke.time_cuda(torch, f, 20, flush)[0] for f in one]
        runs.append({"name": name, "sweep_ms": ms, "bucket_ms": buckets})
        print(f"{name}: sweep {ms:.4f} ms, buckets "
              + " ".join(f"{t:.4f}" for t in buckets))
    print("ms, two runs each: the sweep, then each bucket "
          f"(W = {', '.join(str(w) for w in ell.widths)}), then [2^20, 8] "
          f"at {', '.join(label for label, _, _ in wide)}")
    for i, name in enumerate(names):
        a, b = runs[i], runs[-1 - i]
        cells = [f"{a['sweep_ms']:.4f}/{b['sweep_ms']:.4f}"] + [
            f"{p:.4f}/{q:.4f}" for p, q in zip(a["bucket_ms"],
                                               b["bucket_ms"])]
        print(f"{name:<34} " + "  ".join(cells))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
