"""Data generators of the port (``repro.data``): training batches and
mutation traffic."""
