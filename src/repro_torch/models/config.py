"""Model configuration shared by all 10 assigned architectures (a copy of
``repro.models.config``: the port imports nothing of the JAX package).

The port's ``Model`` runs every family; ``kimi-k2-1t-a32b`` only at its
smoke size, since its full width fits no single card.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False       # qwen2.5
    qk_norm: bool = False        # qwen3
    causal: bool = True          # False for encoder-only (hubert)
    tie_embed: bool = False
    rope_theta: float = 1e4
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0            # shared experts (deepseek-moe)
    capacity_factor: float = 1.25
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 256
    # --- hybrid (recurrentgemma): pattern unit = (rec, rec, attn) ---
    window: int = 0              # local-attention window
    d_rnn: int = 0               # 0 -> d_model
    # --- frontend stubs ---
    frontend: str = ""           # "" | "audio" | "vision"
    frontend_dim: int = 0
    n_patches: int = 0           # vision: tokens contributed by the image
    # --- numerics / perf knobs ---
    attn_chunk: int = 1024
    remat: str = "block"         # "block" | "none"
    moe_local_dispatch: bool = True   # per-data-shard MoE grouping (§Perf)
    # reduced smoke-config marker
    smoke: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def rnn_width(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve a 500k-token context? (SSM / bounded window)"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return self.family != "encoder"

    def param_count_estimate(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv) + self.n_heads * hd * d
        if self.family == "moe":
            ffn = self.n_experts * 3 * d * f + d * self.n_experts \
                + self.n_shared * 3 * d * f
        elif self.family == "ssm":
            di, g, n, h = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            ffn = d * (2 * di + 2 * g * n + h) + di * d
            attn = 0
        else:
            ffn = 3 * d * f
        emb = v * d * (1 if self.tie_embed else 2)
        return self.n_layers * (attn + ffn) + emb
