"""SeamlessM4T-medium [arXiv:2308.11596]: encoder-decoder, multimodal.

The conv/mel audio frontend is a stub per the brief: input_specs provides
frame embeddings [B, T, d_model].  12 encoder + 12 decoder layers
(m4t-medium text stack); GQA kv=16 == MHA.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium", arch_type="audio",
    n_layers=12, n_enc_layers=12, enc_dec=True,
    d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, rope_theta=1e4,
    frontend="audio", act="gelu",
    serve_window=8192,
    source="arXiv:2308.11596"))
