"""The LLM stack's model code (``repro.models``): the dense family."""
