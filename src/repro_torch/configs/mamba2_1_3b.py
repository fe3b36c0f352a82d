"""mamba2-1.3b — attention-free SSD (state-space duality) [arXiv:2405.21060].

DESIGN.md §5 (dry-run policy): registry entry — exact published dims + smoke
variant consumed by the shape-cell grid.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=1, n_kv=1, d_ff=0, vocab=50280, ssm_state=128, ssm_headdim=64,
    ssm_expand=2, ssm_groups=1, ssm_chunk=256)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, vocab=512, ssm_state=16, ssm_headdim=16,
    ssm_chunk=16, smoke=True)
