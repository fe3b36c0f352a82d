"""kimi-k2-1t-a32b — trillion-param MoE: 384 routed experts top-8 + 1 shared
[arXiv:2501.kimi2 paper table].

DESIGN.md §5 (dry-run policy): registry entry — exact published dims + smoke
variant consumed by the shape-cell grid.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv=8, d_ff=2048, vocab=163840, head_dim=112,
    n_experts=384, top_k=8, n_shared=1)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=64, vocab=512,
    head_dim=32, n_experts=8, top_k=2, n_shared=1, capacity_factor=8.0, attn_chunk=64, smoke=True)
