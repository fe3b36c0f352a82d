"""Shared model building blocks (port of ``repro.models.common``): RMSNorm,
RoPE, initialisers that draw from an explicit ``torch.Generator``, and
``associative_scan`` (the algorithm of ``jax.lax.associative_scan``, which
the recurrent layers use).

The port has no sharding yet, so parameters are plain tensors (no ``Param``
boxes) and a parameter tree is a nested dict of them, with the same keys,
shapes and dtypes as the reference's unboxed tree.  Every initialiser
creates its tensor on the generator's device and fills it a slab of the
leading axis at a time (at most 256 MiB in f32, or one layer of a stacked
weight whose layers are larger), so that init holds no more than that in
f32 beside the weights: deepseek-moe-16b's (28, 64, 2048, 1408) expert
weights would take 20.7 GB in f32 at once.  Given a ``MetaGenerator``,
the initialisers make meta tensors and draw nothing: the abstract model of
``Model.init_abstract``, with no memory behind it.
"""
from __future__ import annotations

import math

import torch

__all__ = ["rms_norm", "rope", "apply_rope", "init_dense", "init_embed",
           "init_scalar", "trunc_normal", "associative_scan", "MetaGenerator"]

# f32 elements drawn at a time (256 MiB, a few percent of the smallest
# full-width model's weights): as many leading indices (layers of a
# stacked weight, rows of a 2-D one) as fit, at least one.
_SLAB = 1 << 26


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the ``meta`` device (which
    torch does not make): the initialisers then create meta tensors of
    their shapes and dtypes and draw nothing."""
    device = torch.device("meta")


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


def _slabs(out: torch.Tensor):
    """Views of ``out`` along its leading axis, each at most ``_SLAB``
    elements unless one leading index is larger."""
    per_row = out[0].numel() if out.dim() > 1 else 1
    step = max(1, _SLAB // max(per_row, 1)) if out.dim() > 1 else _SLAB
    return out.split(step) if out.numel() else ()


def trunc_normal(gen: torch.Generator, shape, scale: float,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale``, drawn in f32
    and cast to ``dtype`` (the reference's ``truncated_normal * scale``),
    a slab at a time, scaled in place (one f32 slab alive at a time: a
    layer of kimi-k2-1t-a32b's experts is one 22.5 GB slab)."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if out.is_meta:
        return out
    for slab in _slabs(out):
        w = torch.empty(slab.shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        slab.copy_(w.mul_(scale))
    return out


def init_dense(gen: torch.Generator, in_dim: int, out_dims, dtype=torch.bfloat16,
               scale: float | None = None) -> torch.Tensor:
    """Fan-in scaled truncated-normal init for a (in, *out) weight."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return trunc_normal(gen, (in_dim,) + tuple(out_dims), scale, dtype)


def init_embed(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    out = torch.empty((vocab, d), dtype=dtype, device=gen.device)
    if out.is_meta:
        return out
    for slab in _slabs(out):
        w = torch.empty(slab.shape, dtype=torch.float32, device=gen.device)
        w.normal_(0.0, 1.0, generator=gen)
        slab.copy_(w.mul_(0.02))
    return out


def init_scalar(gen: torch.Generator, shape, fill: float = 1.0,
                dtype=torch.float32) -> torch.Tensor:
    return torch.full(shape, fill, dtype=dtype, device=gen.device)


def associative_scan(fn, elems: tuple, dim: int = 0) -> tuple:
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim`` with
    the associative ``fn(left, right) -> tuple``, by the algorithm of
    ``jax.lax.associative_scan``: combine neighbouring pairs, scan the
    half-length result, then fix the even positions — 2 log2(n) levels of
    tensor ops, and the reference's order of combination."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(x, start, stop=None, step=1):
        return x.narrow(dim, 0, 0) if start >= x.shape[dim] else \
            x[(slice(None),) * (dim % x.dim()) + (slice(start, stop, step),)]

    odd = associative_scan(fn, fn(tuple(sl(e, 0, -1, 2) for e in elems),
                                  tuple(sl(e, 1, None, 2) for e in elems)),
                           dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim) for e, r in zip(elems, even))
    out = []
    for ev, od in zip(even, odd):
        # interleave: even positions from ``ev``, odd ones from ``od``
        if od.shape[dim] < ev.shape[dim]:
            od = torch.cat([od, torch.zeros_like(sl(ev, 0, 1))], dim)
        both = torch.stack([ev, od], dim + 1 if dim >= 0 else dim)
        shape = list(ev.shape)
        shape[dim] = 2 * ev.shape[dim]
        out.append(both.reshape(shape).narrow(dim, 0, n))
    return tuple(out)
