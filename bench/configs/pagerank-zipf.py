"""PageRank over a Zipf configuration-model graph, through the port.

The inputs are the benchmark's edge list (``gen.zipf``); the port
derives its weights, storage and coloring from it in
``repro_torch.apps.pagerank.build``, and a job is one
``repro_torch.api.run`` under the traffic's scheduler.  The reference
works the fixed point out again from the same edge list
(``reference.pagerank``).
"""
import numpy as np

from bench.gen import zipf
from bench.reference import pagerank as ref


def generate(torch, cfg, seed, device):
    edges = zipf.zipf_edges(torch, cfg["n_vertices"], cfg["alpha"], seed,
                            device)
    return {"n_vertices": cfg["n_vertices"], "edges": edges.cpu().numpy()}


def build(torch, cfg, inputs, device):
    from repro_torch.apps import pagerank
    if pagerank.ALPHA != cfg["reset"]:
        raise ValueError(f"the port's reset is {pagerank.ALPHA}, the "
                         f"configuration states {cfg['reset']}")
    return pagerank.build(inputs["edges"], inputs["n_vertices"],
                          eps=cfg["eps"], device=device)


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
    return {"rank": res.vertex_data["rank"].cpu().numpy(),
            "total_rank": float(res.globals["total_rank"]),
            "top2": float(res.globals["top2"][0])}


def check(torch, cfg, traffic, inputs, answers, device):
    best = ref.fixed_point(inputs["edges"], inputs["n_vertices"],
                           cfg["reset"], device).cpu().numpy()
    return [ref.compare(best, a["rank"], a["total_rank"], a["top2"])
            for a in answers]


def control(torch, cfg, traffic, inputs, device):
    """The reference in bfloat16, in the port's place: an answer, its
    syncs summed and picked in bfloat16 too."""
    r = ref.lowp_iteration(inputs["edges"], inputs["n_vertices"],
                           cfg["reset"], device)
    ranks = r.float().cpu().numpy()
    return {"rank": ranks, "total_rank": float(r.sum()),
            "top2": float(np.partition(ranks, -2)[-2])}


def adjacency(torch, cfg, inputs, device):
    e = torch.as_tensor(inputs["edges"], device=device)
    src = torch.cat([e[:, 0], e[:, 1]])
    dst = torch.cat([e[:, 1], e[:, 0]])
    return {"src": src, "dst": dst,
            "deg": torch.bincount(src, minlength=inputs["n_vertices"])}
