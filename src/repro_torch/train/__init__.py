"""Training-side code of the port (``repro.train``): checkpoints, the
train step and the trainer."""
