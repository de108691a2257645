"""Architecture config schema + input-shape registry.

Every assigned architecture gets a ``configs/<id>.py`` exporting
``CONFIG`` (exact sizes from the assignment, source cited) and the four
global input shapes are defined here.  ``reduced()`` derives the smoke
variant (2 layers, d_model <= 512, <= 4 experts) exercised by per-arch
CPU tests.  A copy of ``repro.configs.base`` without its unused JAX
imports, so the port reads the same sizes.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    every: int = 1            # MoE every k-th layer (jamba: 2)


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None   # default ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    qk_norm: bool = False
    geglu: bool = False                  # GeGLU MLP (gemma)
    act: str = "silu"
    rope_theta: float = 1e6
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    attn_every: int = 1                  # hybrid: attention layer period
    window: int | None = None            # training-time sliding window
    serve_window: int | None = None      # serving window for long-context
    enc_dec: bool = False                # seamless: encoder-decoder
    n_enc_layers: int = 0
    frontend: str | None = None          # "vision" | "audio" stubs
    n_frontend_tokens: int = 0           # image/audio embedding positions
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    source: str = ""                     # citation from the assignment

    @property
    def dh(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand if self.ssm else 2) * self.d_model

    def is_attn_layer(self, i: int) -> bool:
        if self.arch_type == "ssm":
            return False
        if self.attn_every == 1:
            return True
        return i % self.attn_every == 0

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.every
                                         == self.moe.every - 1)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, tiny sizes."""
        d = min(self.d_model, 256)
        nh = min(self.n_heads, 4)
        nkv = max(1, min(self.n_kv_heads, nh))
        layers = 2 if self.attn_every == 1 else min(self.n_layers,
                                                    self.attn_every)
        return dataclasses.replace(
            self,
            n_layers=layers,
            d_model=d,
            n_heads=nh,
            n_kv_heads=nkv,
            head_dim=(64 if self.head_dim else None),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            moe=(dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 256))
                if self.moe else None),
            n_enc_layers=min(self.n_enc_layers, 2),
            window=(min(self.window, 64) if self.window else None),
            serve_window=(min(self.serve_window, 64)
                          if self.serve_window else None),
            n_frontend_tokens=min(self.n_frontend_tokens, 16),
        )

    # ------------------------------------------------------------------
    def param_count(self) -> dict:
        """Analytic parameter counts (total + active) for the roofline."""
        d, dh = self.d_model, self.dh
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * dh * d
        mlp_mult = 3 if not self.geglu else 3   # gate+up+down
        dense_mlp = mlp_mult * d * self.d_ff if self.d_ff else 0
        mamba = 0
        if self.ssm is not None:
            di, ds = self.d_inner, self.ssm.d_state
            dtr = self.ssm.dt_rank or -(-d // 16)
            mamba = (d * 2 * di            # in_proj
                     + di * self.ssm.d_conv
                     + di * (dtr + 2 * ds)  # x -> dt, B, C
                     + dtr * di
                     + di * ds + di        # A, D
                     + di * d)             # out_proj
        total = 0
        active = 0
        layers = self.n_layers + self.n_enc_layers
        for i in range(self.n_layers):
            la = attn if self.is_attn_layer(i) else mamba
            if self.is_moe_layer(i):
                lm_total = 3 * d * self.moe.d_ff_expert * self.moe.n_experts
                lm_active = 3 * d * self.moe.d_ff_expert * self.moe.top_k
                lm_total += d * self.moe.n_experts   # router
                lm_active += d * self.moe.n_experts
            else:
                lm_total = lm_active = dense_mlp
            total += la + lm_total
            active += la + lm_active
        for i in range(self.n_enc_layers):
            total += attn + dense_mlp
            active += attn + dense_mlp
        if self.enc_dec:   # decoder cross-attention
            total += self.n_layers * attn
            active += self.n_layers * attn
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return {"total": total + emb, "active": active + emb,
                "embed": emb}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# populated by repro_torch.configs.__init__
REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg
