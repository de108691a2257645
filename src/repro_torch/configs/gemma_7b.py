"""Gemma-7B [arXiv:2403.08295]: GeGLU, head_dim=256, tied embeddings."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-7b", arch_type="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, geglu=True, act="gelu", rope_theta=1e4,
    tie_embeddings=True, serve_window=8192,
    source="arXiv:2403.08295"))
