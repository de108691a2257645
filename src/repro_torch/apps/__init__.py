"""Applications of the port (PageRank so far; the rest is ROADMAP A5)."""
