"""minitron-8b — pruned nemotron, dense GQA, 256k vocab [arXiv:2407.14679].

DESIGN.md §5 (dry-run policy): registry entry — exact published dims + smoke
variant consumed by the shape-cell grid.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_ff=16384, vocab=256000, head_dim=128)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
    head_dim=32, attn_chunk=64, smoke=True)
