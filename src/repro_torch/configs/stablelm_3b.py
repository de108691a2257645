"""StableLM-3B [hf:stabilityai/stablelm-2-1_6b family]: kv=32 (MHA)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-3b", arch_type="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304, rope_theta=1e4,
    serve_window=8192,
    source="hf:stabilityai/stablelm-2-1_6b (3B sizes per assignment)"))
