"""recurrentgemma-9b — hybrid RG-LRU + local attention, (rec, rec, attn)
pattern, MQA kv=1, window 2048 [arXiv:2402.19427].

DESIGN.md §5 (dry-run policy): registry entry — exact published dims + smoke
variant consumed by the shape-cell grid.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv=1, d_ff=12288, vocab=256000, head_dim=256,
    window=2048, d_rnn=4096)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv=1, d_ff=128, vocab=512,
    head_dim=16, window=16, d_rnn=64, attn_chunk=32, smoke=True)
