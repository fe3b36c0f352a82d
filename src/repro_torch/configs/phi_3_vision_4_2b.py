"""phi-3-vision-4.2b — phi3-mini backbone + CLIP patch STUB
[hf:microsoft/Phi-3-vision-128k-instruct].

DESIGN.md §5 (dry-run policy): registry entry — exact published dims + smoke
variant consumed by the shape-cell grid.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv=32, d_ff=8192, vocab=32064, head_dim=96,
    frontend="vision", frontend_dim=1024, n_patches=576)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
    head_dim=32, frontend_dim=16, n_patches=4, attn_chunk=64, smoke=True)
