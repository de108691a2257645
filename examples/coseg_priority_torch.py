"""CoSeg (paper §5.2) on the PyTorch/CUDA port: residual-prioritized LBP
with the GMM sync under three schedulers through ``repro_torch.api``.

The port's twin of ``examples/coseg_priority.py``: one CoSeg problem
under ``chromatic`` (fixed sweeps), ``priority`` (the top 64 residuals a
superstep, color by color) and ``locking`` (a 64-deep pending window,
min-id claim winners, no coloring needed).  Runs on the GPU by default;
``--device cpu`` runs it on the CPU.

    PYTHONPATH=src python examples/coseg_priority_torch.py [--device cpu]
"""
import argparse
import time

from repro_torch import api
from repro_torch.apps import lbp

K = 4          # labels
FEAT = 3


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args()

    prob = lbp.synthetic_coseg(n_frames=6, h=6, w=12, n_labels=K,
                               n_feat=FEAT, noise=0.55, seed=0,
                               device=args.device)
    g, upd, syncs = lbp.build(prob, beta=0.6, eps=5e-3, tau=2)
    nv = g.n_vertices
    base = float((g.vertex_data["unary"].argmax(1).cpu().numpy()
                  == prob.true_labels).mean())
    print(f"CoSeg grid {prob.shape}: {nv} super-pixels, {g.n_edges} edges, "
          f"{g.n_colors} colors on {g.device} | unary-only accuracy "
          f"{base:.3f}")

    runs = (("chromatic (fixed sweeps)", "chromatic",
             {"max_supersteps": 40}),
            ("priority (k_select=64)", "priority",
             {"k_select": 64, "max_supersteps": 20000}),
            ("locking (claim pass, max_pending=64)", "locking",
             {"max_pending": 64, "max_supersteps": 20000}))
    for label, scheduler, opts in runs:
        t0 = time.time()
        res = api.run(g, upd, syncs=syncs, scheduler=scheduler,
                      device=args.device, **opts)
        secs = time.time() - t0
        acc = lbp.label_accuracy(prob, res.vertex_data)
        print(f"{label}: {res.superstep} supersteps, {res.n_updates} "
              f"updates ({res.n_updates / nv:.1f} a super-pixel), "
              f"{secs:.2f} s, acc {acc:.3f}")
    print("GMM centroids (sync):")
    print(res.globals["gmm"].cpu().numpy().round(2))


if __name__ == "__main__":
    main()
