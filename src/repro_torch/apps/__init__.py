"""Applications of the port: PageRank, ALS, CC, CoEM, CoSeg LBP, Gibbs
and BPTF.

Every app module exposes the reference's three-part surface:
``make_update(...)``, a graph or problem builder with its sync ops, and
``build(...) -> (graph, update, syncs)``, the triple
``repro_torch.api.run`` consumes.
"""
from repro_torch.apps import als, bptf, cc, coem, gibbs, lbp, pagerank

#: name -> uniform ``build(...) -> (graph, update, syncs)`` helper
BUILDERS = {
    "pagerank": pagerank.build,
    "als": als.build,
    "cc": cc.build,
    "coem": coem.build,
    "lbp": lbp.build,
    "gibbs": gibbs.build,
    "bptf": bptf.build,
}

__all__ = ["als", "bptf", "cc", "coem", "gibbs", "lbp", "pagerank",
           "BUILDERS"]
