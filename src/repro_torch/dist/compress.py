"""int8 gradient compression with error feedback for cross-node traffic
(port of ``repro.dist.compress``), over nested dicts of tensors.

Each leaf is scaled to int8 by its max-abs (one f32 scale per leaf), and
the quantization residual is carried to the next step (error feedback), so
the time-averaged applied gradient is unbiased.  Rounding is half to even,
as ``jnp.round``.
"""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import tree_map, tree_unzip

__all__ = ["zeros_residuals", "ef_compress_tree", "ef_decompress_tree"]


def zeros_residuals(tree: dict) -> dict:
    """Initial (zero) error-feedback residuals for a gradient tree."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def _compress_leaf(g: torch.Tensor, r: torch.Tensor):
    x = g.to(torch.float32) + r
    scale = torch.clamp(x.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale, x - q.to(torch.float32) * scale


def ef_compress_tree(grads: dict, residuals: dict):
    """(grads, residuals) -> (int8 tree, scale tree, new residuals)."""
    return tree_unzip(tree_map(_compress_leaf, grads, residuals), 3)


def ef_decompress_tree(q_tree: dict, scale_tree: dict) -> dict:
    """Inverse of ``ef_compress_tree``: int8 + per-leaf scale -> f32 tree."""
    return tree_map(lambda q, s: q.to(torch.float32) * s, q_tree, scale_tree)
