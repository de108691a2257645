"""Training-side utilities of the port (``repro.train``): checkpoints."""
