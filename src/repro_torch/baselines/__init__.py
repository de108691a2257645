"""Baselines of the paper's §6.2 comparisons, on the port (the MapReduce
jobs so far; the MPI ALS baseline is ROADMAP A9)."""
