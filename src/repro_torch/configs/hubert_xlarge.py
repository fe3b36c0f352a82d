"""hubert-xlarge — audio encoder-only backbone; conv frontend is a STUB
(input_specs supplies 49 Hz frame embeddings) [arXiv:2106.07447].

DESIGN.md §5 (dry-run policy): registry entry — exact published dims + smoke
variant consumed by the shape-cell grid.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder", n_layers=48, d_model=1280,
    n_heads=16, n_kv=16, d_ff=5120, vocab=504, head_dim=80, causal=False,
    frontend="audio", frontend_dim=512)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=64,
    head_dim=32, frontend_dim=16, attn_chunk=64, smoke=True)
