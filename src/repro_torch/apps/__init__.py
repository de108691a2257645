"""Applications of the port (PageRank, ALS, CC, CoEM and CoSeg LBP so
far; the rest is ROADMAP A5).

Every app module exposes the reference's three-part surface:
``make_update(...)``, a graph or problem builder with its sync ops, and
``build(...) -> (graph, update, syncs)``, the triple
``repro_torch.api.run`` consumes.
"""
from repro_torch.apps import als, cc, coem, lbp, pagerank

#: name -> uniform ``build(...) -> (graph, update, syncs)`` helper
BUILDERS = {
    "pagerank": pagerank.build,
    "als": als.build,
    "cc": cc.build,
    "coem": coem.build,
    "lbp": lbp.build,
}

__all__ = ["als", "cc", "coem", "lbp", "pagerank", "BUILDERS"]
