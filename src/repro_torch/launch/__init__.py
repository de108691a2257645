"""Command-line launchers (``repro.launch``)."""
