"""LLaVA-NeXT 34B [hf:llava-hf/llava-v1.6-mistral-7b-hf family].

Vision frontend is a stub per the brief: input_specs provides projected
anyres patch embeddings (base 576 + 4 tiles x 576 = 2880 tokens).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-34b", arch_type="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, rope_theta=5e6,
    frontend="vision", n_frontend_tokens=2880,
    serve_window=8192,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (34B per assignment)"))
