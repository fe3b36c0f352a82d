"""deepseek-moe-16b — fine-grained MoE: 64 routed top-6 + 2 shared experts
[arXiv:2401.06066].

DESIGN.md §5 (dry-run policy): registry entry — exact published dims + smoke
variant consumed by the shape-cell grid.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv=16, d_ff=1408, vocab=102400, head_dim=128,
    n_experts=64, top_k=6, n_shared=2)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=64, vocab=512,
    head_dim=32, n_experts=8, top_k=2, n_shared=2, capacity_factor=8.0, attn_chunk=64, smoke=True)
