"""Data generators of the port (``repro.data``): mutation traffic."""
