"""mistral-large-123b — dense 88L GQA [hf:mistralai/Mistral-Large-Instruct-2407].

DESIGN.md §5 (dry-run policy): registry entry — exact published dims + smoke
variant consumed by the shape-cell grid.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense", n_layers=88, d_model=12288,
    n_heads=96, n_kv=8, d_ff=28672, vocab=32768, head_dim=128,
    rope_theta=1e6)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    head_dim=32, attn_chunk=64, smoke=True)
