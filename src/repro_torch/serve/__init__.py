"""Serving (``repro.serve``): the KV-cache decode step."""
