#!/usr/bin/env python3
"""Time ``als_normal_eq`` on ``chip_smoke.py``'s ALS shapes (the two
folds of a superstep of the 48,019 x 17,770, d = 20 Netflix-shaped
problem, and d = 64 at its widest bucket) under several kernel
geometries, on one GPU.

    python3 tools/als_normal_eq_sweep.py [--geometries '64x4x4;128x2x2'] \\
        [--baseline OLD.cu] [--json PATH]

A geometry ``WINxCHUNKxROWS[:-DFLAG...]`` builds ``csrc/als_normal_eq.cu``
with ``-DALS_WIN=WIN -DALS_CHUNK=CHUNK -DALS_ROWS_PER_BLOCK=ROWS`` (the
mask slots a window scans, the windows of mask a lane loads at once,
the rows a block takes where one warp owns a row) and any further flags
given after colons, under a name of its own; the wrapper plans with the
geometry that build reports.  ``--baseline`` builds an
``als_normal_eq.cu`` of the one-block-a-row interface (the repository's
before the table launch: ``als_normal_eq_launch(nbrs, mask, ratings, x,
a, b, n_rows, width, n_src, d, stream)``) and runs the folds through an
identity index made outside the timing.  Every contender is checked
bitwise against the plain version at every shape, then timed after an L2
flush; the contenders run in turns, first to last and back again, beside
two ``torch.bmm`` calls on the masked scope (the library yardstick).
Prints a table of ms and, with ``--json PATH``, writes every time there.
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

from tools.ell_spmv_sweep import build_all  # noqa: E402


def baseline_fn(torch, lib, nbrs, mask, r, x):
    """One launch of the one-block-a-row kernel, as its wrapper made it."""
    p = ctypes.c_void_p
    lib.als_normal_eq_launch.argtypes = [p, p, p, p, p, p, ctypes.c_int64,
                                         ctypes.c_int32, ctypes.c_int64,
                                         ctypes.c_int32, p]
    lib.als_normal_eq_launch.restype = ctypes.c_int
    nv, width = mask.shape
    d = x.shape[1]
    a = torch.empty((nv, d, d), dtype=torch.float32, device=x.device)
    b = torch.empty((nv, d), dtype=torch.float32, device=x.device)

    def run():
        err = lib.als_normal_eq_launch(
            nbrs.data_ptr(), mask.data_ptr(), r.data_ptr(), x.data_ptr(),
            a.data_ptr(), b.data_ptr(), nv, width, x.shape[0], d,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline launch failed: {err}")
        return a, b
    return run


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.apps import als
    from repro_torch.kernels import _build
    from repro_torch.kernels import als_normal_eq as ae
    ap = argparse.ArgumentParser()
    ap.add_argument("--geometries", default="64x4x4",
                    help="';'-separated WINxCHUNKxROWS builds of the kernel")
    ap.add_argument("--baseline", type=Path,
                    help="an als_normal_eq.cu of the one-block-a-row "
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
    srcs = {}
    for g in filter(None, args.geometries.split(";")):
        geom, *flags = g.split(":")
        win, chunk, rows = (int(v) for v in geom.split("x"))
        srcs[f"{geom}{''.join(flags)}"] = (
            _build.CSRC / "als_normal_eq.cu",
            [f"-DALS_WIN={win}", f"-DALS_CHUNK={chunk}",
             f"-DALS_ROWS_PER_BLOCK={rows}", *flags])
    if args.baseline:
        srcs["baseline"] = (args.baseline, [])
    libs = build_all(srcs)

    prob = als.synthetic_netflix(
        chip_smoke.ALS_USERS, chip_smoke.NETFLIX_MOVIES, d=chip_smoke.ALS_D,
        density=chip_smoke.ALS_DENSITY, noise=chip_smoke.ALS_NOISE, seed=0,
        device=dev)
    graph, ell, d = prob.graph, prob.graph.ell, prob.d
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device=dev)
    cases = []          # (label, fold args or None, bucket args or None)
    for c in range(graph.n_colors):
        scope = chip_smoke.color_scope(torch, graph, c)
        X = scope.nbr_data["w"]
        mask, r = scope.nbr_mask, scope.edge_data["rating"]
        nv, width = mask.shape
        print(f"fold, color {c}: [{nv}, {width}] d={d}, real "
              f"{int(mask.sum())}, empty rows {int((~mask.any(1)).sum())}")
        cases.append((f"fold {c}", (mask, r, X)))
    b = max(range(ell.n_buckets), key=lambda i: ell.bucket_launches[i][0]
            * ell.bucket_launches[i][1])
    ratings = graph.edge_data["rating"]
    r_b = ratings[ell.edge_ids[b].long()].contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    x64 = torch.randn((graph.n_vertices, 64), generator=gen, device=dev)
    cases.append((f"bucket {b} d=64", (ell.nbrs[b], ell.nbr_mask[b], r_b,
                                       x64)))
    wants = []
    for label, a in cases:
        if label.startswith("fold"):
            mask, r, X = a
            wants.append(ae.als_normal_eq_plain(None, mask, r,
                                                X.view(-1, X.shape[2])))
        else:
            wants.append(ae.als_normal_eq_plain(*a))
    lib_ms = []
    for label, a in cases:
        if label.startswith("fold"):
            mask, r, X = a
            xm = X * mask[..., None]
        else:
            nb, mask, r, x = a
            xm = x[nb.long()] * mask[..., None]
        rm = (r * mask)[..., None]
        xt = xm.transpose(1, 2)
        lib_ms.append(chip_smoke.time_cuda(
            torch, lambda: (torch.bmm(xt, xm), torch.bmm(xt, rm)), 10,
            flush)[0])
        del xm, rm, xt
    print("torch.bmm (library): " + " ".join(f"{t:.4f}" for t in lib_ms))

    def use(name):
        """Point the wrapper at a contender's build; return its calls."""
        if name == "baseline":
            fns = []
            for label, a in cases:
                if label.startswith("fold"):
                    mask, r, X = a
                    nv, width, dd = X.shape
                    idx = (torch.arange(nv, dtype=torch.int32, device=dev)
                           [:, None] * width
                           + torch.arange(width, dtype=torch.int32,
                                          device=dev))
                    fns.append(baseline_fn(torch, libs[name], idx, mask, r,
                                           X.view(nv * width, dd)))
                else:
                    fns.append(baseline_fn(torch, libs[name], *a))
            return fns
        ae._lib = None
        ae.geometry.cache_clear()
        saved = _build.load
        _build.load = lambda _: libs[name]
        try:
            ae._kernel_lib()
        finally:
            _build.load = saved
        print(f"{name}: (warps a row, rows a block, window) at d = 20 "
              f"{ae.geometry(20)}, at d = 64 {ae.geometry(64)}")
        return [(lambda a=a: ae.als_normal_eq_fold(*a))
                if label.startswith("fold")
                else (lambda a=a: ae.als_normal_eq(*a))
                for label, a in cases]

    names = list(srcs)
    runs = []
    for name in names + names[::-1]:
        fns = use(name)
        for (label, _), f, want in zip(cases, fns, wants):
            got = f()
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name}: {label} differs from the "
                                     "plain version")
        times = [chip_smoke.time_cuda(torch, f, 10, flush)[0] for f in fns]
        runs.append({"name": name, "ms": times})
        print(f"{name}: " + " ".join(f"{t:.4f}" for t in times))
    print("ms, two runs each: " + ", ".join(label for label, _ in cases)
          + ", the two folds' sum")
    for i, name in enumerate(names):
        a, b = runs[i]["ms"], runs[-1 - i]["ms"]
        n_f = len(cases) - 1
        cells = [f"{p:.4f}/{q:.4f}" for p, q in zip(a, b)]
        cells.append(f"{sum(a[:n_f]):.4f}/{sum(b[:n_f]):.4f}")
        print(f"{name:<24} " + "  ".join(cells))
    print(f"{'torch.bmm':<24} " + "  ".join(f"{t:.4f}" for t in lib_ms)
          + f"  {sum(lib_ms[:-1]):.4f}")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"runs": runs, "library_ms": lib_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
