"""Falcon-Mamba 7B [arXiv:2410.05355]: pure Mamba-1, attention-free."""
from repro_torch.configs.base import ModelConfig, SSMCfg, register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b", arch_type="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=65024,
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2),
    source="arXiv:2410.05355"))
