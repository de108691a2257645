"""ALS over Netflix-shaped ratings, through the port.

The inputs are the benchmark's rating triples and starting factors
(``gen.netflix``, made on the device); the port builds its bipartite
graph from them in ``repro_torch.apps.als.from_ratings``, and a job is
one ``repro_torch.api.run`` under the traffic's scheduler: ``d``-wide
factors, the ALS-WR ridge ``lam``, every vertex rescheduled while its
factor moves by more than ``eps``.  The reference replays the same
sweeps in float64 from the same triples and ``w0``
(``reference.als``).
"""
import sys

import numpy as np

from bench.gen import netflix
from bench.reference import als as ref


def _stats(deg):
    d = deg.double()
    return (f"median {float(d.median())}, mean {float(d.mean())}, "
            f"max {int(deg.max())}, min {int(deg.min())}")


def generate(torch, cfg, seed, device):
    # the port's entry for given triples: a port without it stops here,
    # before any work
    from repro_torch.apps.als import from_ratings  # noqa: F401
    t = netflix.netflix(torch, cfg, seed, device)
    for side, ids, n in (("users", t["users"], cfg["n_users"]),
                         ("movies", t["movies"], cfg["n_movies"])):
        print(f"gen: {side}: {ids.shape[0]} ratings, degrees "
              + _stats(torch.bincount(ids, minlength=n)),
              file=sys.stderr, flush=True)
    return {"users": t["users"].int().cpu().numpy(),
            "movies": t["movies"].int().cpu().numpy(),
            "ratings": t["ratings"].cpu().numpy(),
            "w0": t["w0"].cpu().numpy()}


def build(torch, cfg, inputs, device):
    from repro_torch.apps import als
    pairs = np.stack([inputs["users"], inputs["movies"]], axis=1)
    problem = als.from_ratings(cfg["n_users"], cfg["n_movies"], pairs,
                               inputs["ratings"], cfg["d"], inputs["w0"],
                               device=device)
    return als.build(problem, lam=cfg["lam"], eps=cfg["eps"])


def job(torch, cfg, traffic, built, device):
    """One ``api.run`` from the built graph's initial data; keyword
    arguments override the traffic's."""
    from repro_torch import api
    graph, update, syncs = built
    kwargs = dict(traffic.get("run", {}))

    def run(**override):
        return api.run(graph, update, scheduler=traffic["scheduler"],
                       syncs=syncs, device=device, **{**kwargs, **override})
    return run


def answer(cfg, res):
    return {"w": res.vertex_data["w"].cpu().numpy(),
            "rmse": float(res.globals["rmse"]),
            "supersteps": int(res.superstep),
            "n_updates": int(res.n_updates)}


def _triples(cfg, inputs, device):
    return ref.Triples(cfg["n_users"], cfg["n_movies"], inputs["users"],
                       inputs["movies"], inputs["ratings"], device)


def check(torch, cfg, traffic, inputs, answers, device):
    triples = _triples(cfg, inputs, device)
    nv = cfg["n_users"] + cfg["n_movies"]
    best = {}
    out = []
    for a in answers:
        steps = a["supersteps"]
        if steps not in best:
            w = ref.sweeps(triples, inputs["w0"], cfg["lam"], steps)
            best[steps] = (w, ref.rmse(triples, w))
        w, err = best[steps]
        out.append(ref.compare(triples, w, err, a["w"], a["rmse"],
                               nv * steps - a["n_updates"]))
    return out


def control(torch, cfg, traffic, inputs, device):
    """The reference in bfloat16 factors and ratings (float32 sums and
    solve), in the port's place, for as many sweeps as a job runs; its
    RMSE summed in float32 over bfloat16 values too."""
    triples = _triples(cfg, inputs, device)
    steps = traffic["run"]["max_supersteps"]
    w = ref.sweeps(triples, inputs["w0"], cfg["lam"], steps, lowp=True)
    return {"w": w.float().cpu().numpy(),
            "rmse": ref.rmse(triples, w, lowp=True),
            "supersteps": steps,
            "n_updates": (cfg["n_users"] + cfg["n_movies"]) * steps}


def adjacency(torch, cfg, inputs, device):
    u = torch.as_tensor(inputs["users"], device=device).long()
    m = torch.as_tensor(inputs["movies"], device=device).long()
    m += cfg["n_users"]
    src = torch.cat([u, m])
    return {"src": src, "dst": torch.cat([m, u]),
            "deg": torch.bincount(src,
                                  minlength=cfg["n_users"] + cfg["n_movies"])}
