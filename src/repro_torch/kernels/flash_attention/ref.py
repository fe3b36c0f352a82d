"""Plain PyTorch version of ``flash_attention`` (port of
``repro.kernels.flash_attention.ref``): the dense masked softmax over the
whole (S, S) score matrix, in f32.  The yardstick the CUDA kernel is held
to."""
from __future__ import annotations

import torch

__all__ = ["flash_attention_ref", "NEG_INF"]

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, S, D); k/v: (B, KH, S, D) -> (B, H, S, D) in q's dtype."""
    s, d = q.shape[2], q.shape[3]
    h, kh = q.shape[1], k.shape[1]
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=1)
        v = v.repeat_interleave(h // kh, dim=1)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                      k.to(torch.float32)) * d ** -0.5
    pos = torch.arange(s, device=q.device)
    valid = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        valid &= pos[None, :] <= pos[:, None]
    if window:
        valid &= pos[None, :] > pos[:, None] - window
    sc = torch.where(valid[None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)
