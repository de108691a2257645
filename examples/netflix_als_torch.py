"""The paper's Netflix experiment (§5.1) in miniature, on the PyTorch/CUDA
port: ALS collaborative filtering through ``repro_torch.api``.

The GraphLab half of ``examples/netflix_als.py``: synthetic ratings ->
bipartite data graph -> the chromatic engine with the RMSE sync.  The
normal equations of every update go through the ``als_normal_eq`` CUDA
kernel.  Runs on the GPU by default; ``--device cpu`` runs it on the CPU
(the kernel's plain version).

    PYTHONPATH=src python examples/netflix_als_torch.py [--device cpu]
"""
import argparse
import time

from repro_torch import api
from repro_torch.apps import als
from repro_torch.kernels.als_normal_eq import als_normal_eq

D = 8
SWEEPS = 20


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args()

    prob = als.synthetic_netflix(n_users=300, n_movies=200, d=D,
                                 density=0.06, noise=0.08, seed=0,
                                 device=args.device)
    g, upd, syncs = als.build(prob, lam=0.05, eps=1e-3)
    print(f"Netflix-style problem: {prob.n_users} users x "
          f"{prob.n_movies} movies, {g.n_edges} ratings, d={D}, on "
          f"{g.device}")

    launches = als_normal_eq.launches
    t0 = time.time()
    out = api.run(g, upd, syncs=syncs, scheduler="chromatic",
                  max_supersteps=SWEEPS, device=args.device)
    t_gl = time.time() - t0
    rmse = als.dataset_rmse(prob, out.vertex_data)
    print(f"GraphLab ALS: {out.superstep} supersteps, {out.n_updates} "
          f"updates, {t_gl:.2f}s | sync RMSE {float(out.globals['rmse']):.4f} "
          f"(exact {rmse:.4f}, noise floor ~{prob.noise}) | als_normal_eq "
          f"kernel launches {als_normal_eq.launches - launches}")


if __name__ == "__main__":
    main()
