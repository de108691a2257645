"""Assigned-architecture registry: import to populate REGISTRY."""
from repro_torch.configs.base import (INPUT_SHAPES, REGISTRY, InputShape,
                                      ModelConfig, MoECfg, SSMCfg)
from repro_torch.configs import (qwen3_moe_235b_a22b, llava_next_34b,
                                 qwen3_4b, phi35_moe_42b_a66b,
                                 deepseek_coder_33b, seamless_m4t_medium,
                                 stablelm_3b, falcon_mamba_7b,
                                 jamba_15_large_398b, gemma_7b)

ARCHS = sorted(REGISTRY)


def get(name: str) -> ModelConfig:
    return REGISTRY[name]
