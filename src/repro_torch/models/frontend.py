"""Modality frontend stubs (port of ``repro.models.frontend``): the audio
(hubert) and vision (phi-3-vision) entries are backbone-only, so their
inputs are precomputed frame or patch embeddings.

* audio: (B, S, frontend_dim) frame embeddings, one per 49 Hz frame that
  a conv feature encoder would give;
* vision: (B, n_patches, frontend_dim) patch embeddings that a CLIP
  ViT-L/14 would give.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["frontend_spec", "fake_frontend_batch"]


def frontend_spec(cfg: ModelConfig, batch: int, seq: int):
    """``(shape, dtype)`` of the frontend input, or None without one."""
    if cfg.frontend == "audio":
        return (batch, seq, cfg.frontend_dim), torch.bfloat16
    if cfg.frontend == "vision":
        return (batch, cfg.n_patches, cfg.frontend_dim), torch.bfloat16
    return None


def fake_frontend_batch(cfg: ModelConfig, gen: torch.Generator, batch: int,
                        seq: int):
    """Standard normal features of ``frontend_spec``'s shape, drawn in f32
    from ``gen`` on its device and cast; None without a frontend."""
    spec = frontend_spec(cfg, batch, seq)
    if spec is None:
        return None
    shape, dtype = spec
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype)
