"""Plain PyTorch versions of ``flash_attention`` and of its backward (port
of ``repro.kernels.flash_attention.ref``, and of the reference's
``_flash_vjp_bwd`` in the kernel's layout): the masked softmax over
the whole (S, S) score matrix, in f32.  The yardsticks the CUDA kernels
are held to."""
from __future__ import annotations

import torch

__all__ = ["flash_attention_ref", "flash_attention_bwd_ref", "NEG_INF"]

NEG_INF = -1e30


def _valid(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
           window: int) -> torch.Tensor:
    valid = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                       device=q_pos.device)
    if causal:
        valid &= k_pos[None, :] <= q_pos[:, None]
    if window:
        valid &= k_pos[None, :] > q_pos[:, None] - window
    return valid


def _repeat_kv(q, k, v):
    h, kh = q.shape[1], k.shape[1]
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=1)
        v = v.repeat_interleave(h // kh, dim=1)
    return k.to(torch.float32), v.to(torch.float32)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """q: (B, H, S, D); k/v: (B, KH, S, D) -> (B, H, S, D) in q's dtype;
    with ``return_lse`` ``(out, lse, out32)``, as ``flash_attention_cuda``:
    also the (B, H, S) f32 log-sum-exp of each row's scaled, masked scores
    and the output in f32 before its rounding."""
    s, d = q.shape[2], q.shape[3]
    k, v = _repeat_kv(q, k, v)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k) * d ** -0.5
    pos = torch.arange(s, device=q.device)
    sc = torch.where(_valid(pos, pos, causal, window)[None, None], sc,
                     NEG_INF)
    out32 = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(sc, dim=-1), v)
    out = out32.to(q.dtype)
    return (out, torch.logsumexp(sc, dim=-1), out32) if return_lse else out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor,
                            lse: torch.Tensor, *, causal: bool = True,
                            window: int = 0, chunk: int = 1024):
    """The backward ``flash_attention_bwd_cuda`` computes, in f32 over
    query chunks of ``chunk`` rows (any S): ``delta = rowsum(dout * out)``,
    ``p = exp(scale * q k^T - lse)`` under the masks, ``dv = p^T dout``,
    ``ds = p * (dout v^T - delta)``, ``dq = scale * ds k`` and ``dk = scale
    * ds^T q``, a kv head's dk and dv summed over its query heads.  q, out,
    dout: (B, H, S, D); k/v: (B, KH, S, D); lse: (B, H, S) f32.  Returns
    ``(dq, dk, dv)`` in q's dtype."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    scale = d ** -0.5
    kr, vr = _repeat_kv(q, k, v)
    q32, do32 = q.to(torch.float32), dout.to(torch.float32)
    delta = (do32 * out.to(torch.float32)).sum(-1)          # (B, H, S)
    dk = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    k_pos = torch.arange(s, device=q.device)
    for q0 in range(0, s, chunk):
        sl = slice(q0, min(q0 + chunk, s))
        sc = torch.einsum("bhqd,bhkd->bhqk", q32[:, :, sl], kr) * scale
        valid = _valid(k_pos[sl], k_pos, causal, window)
        sc = torch.where(valid[None, None], sc, NEG_INF)
        p = torch.exp(sc - lse[:, :, sl, None])
        dv += torch.einsum("bhqk,bhqd->bhkd", p, do32[:, :, sl])
        dp = torch.einsum("bhqd,bhkd->bhqk", do32[:, :, sl], vr)
        ds = p * (dp - delta[:, :, sl, None])
        dqs.append(torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, q32[:, :, sl]) * scale
    g = h // kh
    dk = dk.view(b, kh, g, s, d).sum(2)
    dv = dv.view(b, kh, g, s, d).sum(2)
    return (torch.cat(dqs, 2).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype))
