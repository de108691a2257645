"""Phi-3.5-MoE 42B-A6.6B [hf:microsoft/Phi-3.5-MoE-instruct]: 16e top-2."""
from repro_torch.configs.base import ModelConfig, MoECfg, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b", arch_type="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=0, vocab=32064, rope_theta=1e4,
    moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=6400),
    serve_window=8192,
    source="hf:microsoft/Phi-3.5-MoE-instruct"))
