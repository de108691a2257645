"""DeepSeek-Coder 33B [arXiv:2401.14196]: llama-arch dense, GQA kv=8."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-coder-33b", arch_type="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256, rope_theta=1e5,
    serve_window=8192,
    source="arXiv:2401.14196"))
