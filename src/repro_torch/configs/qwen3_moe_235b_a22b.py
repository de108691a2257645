"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family; sizes per assignment].

128 experts top-8, GQA kv=4, qk_norm, head_dim=128 (Qwen3 family uses 128).
"""
from repro_torch.configs.base import ModelConfig, MoECfg, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b", arch_type="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=0, vocab=151936, qk_norm=True, rope_theta=1e6,
    moe=MoECfg(n_experts=128, top_k=8, d_ff_expert=1536),
    serve_window=8192,
    source="hf:Qwen/Qwen3-30B-A3B (scaled per assignment)"))
