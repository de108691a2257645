"""Jamba-1.5-Large 398B [arXiv:2403.19887]: Mamba+attention 1:7, MoE 16e top-2.

Every 8th layer is attention (attn_every=8), MoE on every 2nd layer
(moe.every=2), head_dim=128.
"""
from repro_torch.configs.base import ModelConfig, MoECfg, SSMCfg, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b", arch_type="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536, rope_theta=1e6,
    moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=24576, every=2),
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2),
    attn_every=8,
    source="arXiv:2403.19887"))
