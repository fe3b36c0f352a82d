"""Shared model building blocks (port of ``repro.models.common``): RMSNorm,
RoPE and initialisers that draw from an explicit ``torch.Generator``.

The port has no sharding yet, so parameters are plain tensors (no ``Param``
boxes) and a parameter tree is a nested dict of them, with the same keys,
shapes and dtypes as the reference's unboxed tree.  Every initialiser
creates its tensor on the generator's device.
"""
from __future__ import annotations

import math

import torch

__all__ = ["rms_norm", "rope", "apply_rope", "init_dense", "init_embed",
           "init_scalar", "trunc_normal"]


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * gamma).to(dt)


def rope(positions: torch.Tensor, head_dim: int, theta: float = 1e4):
    """Rotary tables ``(sin, cos)``, each ``(*positions.shape, head_dim/2)``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exps)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); sin/cos: (seq, head_dim/2).  f32."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    s = sin[..., :, None, :]
    c = cos[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def trunc_normal(gen: torch.Generator, shape, scale: float,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale``, drawn in f32
    and cast to ``dtype`` (the reference's ``truncated_normal * scale``)."""
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


def init_dense(gen: torch.Generator, in_dim: int, out_dims, dtype=torch.bfloat16,
               scale: float | None = None) -> torch.Tensor:
    """Fan-in scaled truncated-normal init for a (in, *out) weight."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return trunc_normal(gen, (in_dim,) + tuple(out_dims), scale, dtype)


def init_embed(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=gen.device)
    w.normal_(0.0, 1.0, generator=gen)
    return (w * 0.02).to(dtype)


def init_scalar(gen: torch.Generator, shape, fill: float = 1.0,
                dtype=torch.float32) -> torch.Tensor:
    return torch.full(shape, fill, dtype=dtype, device=gen.device)
