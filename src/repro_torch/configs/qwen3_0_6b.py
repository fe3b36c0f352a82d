"""qwen3-0.6b — dense GQA with qk_norm [hf:Qwen/Qwen3-0.6B].

head_dim=128 (decoupled from d_model/n_heads, as in the HF config).

DESIGN.md §5 (dry-run policy): registry entry — exact published dims + smoke
variant consumed by the shape-cell grid.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024,
    n_heads=16, n_kv=8, d_ff=3072, vocab=151936, head_dim=128,
    qk_norm=True, tie_embed=True, rope_theta=1e6)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    head_dim=32, attn_chunk=64, smoke=True)
