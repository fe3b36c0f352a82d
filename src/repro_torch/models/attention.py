"""Grouped-query attention (port of ``repro.models.attention``, forward
only): the prefill path ``gqa_attention`` and the cached one-token path
``decode_attention``, in the reference's layouts.

Each function picks its implementation from the device of its input, in
one place (``core.combine.resolve_backend``): CUDA tensors go to the
hand-written kernels (``flash_attention_cuda``, and ``paged_attention_cuda``
over the dense cache viewed as one page per sequence under the identity
block table), CPU tensors to the plain versions below.  The plain
``gqa_attention`` is the reference's chunked online softmax
(``_flash_fwd_impl``); the plain ``decode_attention`` is its dense masked
softmax.  The backward (training) arrives with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.combine import resolve_backend
from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
from repro_torch.kernels.paged_attention.ops import paged_attention_cuda

__all__ = ["gqa_attention", "decode_attention", "NEG_INF"]

NEG_INF = -1e30


def _mask_block(qi, ki, qc, kc, causal, window, device):
    q_pos = qi * qc + torch.arange(qc, device=device)
    k_pos = ki * kc + torch.arange(kc, device=device)
    valid = torch.ones((qc, kc), dtype=torch.bool, device=device)
    if causal:
        valid &= k_pos[None, :] <= q_pos[:, None]
    if window:
        valid &= k_pos[None, :] > q_pos[:, None] - window
    return valid


def _flash_fwd_plain(q, k, v, causal, window, qc, kc):
    """Chunked online-softmax forward; (b, s, h, d) f32 inputs, q scaled."""
    b, s, h, d = q.shape
    n_q, n_k = s // qc, s // kc
    qr = q.reshape(b, n_q, qc, h, d)
    kr = k.reshape(b, n_k, kc, h, d)
    vr = v.reshape(b, n_k, kc, h, d)
    outs = []
    for qi in range(n_q):
        qblk = qr[:, qi]
        acc = q.new_zeros((b, qc, h, d))
        m_run = q.new_full((b, qc, h), NEG_INF)
        l_run = q.new_zeros((b, qc, h))
        for ki in range(n_k):
            sc = torch.einsum("bqhd,bchd->bqhc", qblk, kr[:, ki])
            valid = _mask_block(qi, ki, qc, kc, causal, window, q.device)
            sc = torch.where(valid[None, :, None, :], sc, NEG_INF)
            m_new = torch.maximum(m_run, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhc,bchd->bqhd", p, vr[:, ki])
            m_run = m_new
        outs.append(acc / l_run.clamp_min(1e-30)[..., None])
    return torch.cat(outs, 1)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, chunk: int = 1024
                  ) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, S, K, D) with H % K == 0.  Returns
    (B, S, H, D) in q's dtype.  The plain version, like the reference,
    needs S to be a multiple of ``min(chunk, S)``; the kernel takes any S."""
    if resolve_backend("auto", q.device) == "cuda":
        out = flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window)
        return out.transpose(1, 2)
    s, h, d = q.shape[1], q.shape[2], q.shape[3]
    kh = k.shape[2]
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    c = min(chunk, s)
    out = _flash_fwd_plain(q.to(torch.float32) * d ** -0.5,
                           k.to(torch.float32), v.to(torch.float32),
                           causal, window, c, c)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length) -> torch.Tensor:
    """One-token decode: q (B, 1, H, D); caches (B, Smax, K, D); attend over
    positions < ``length`` (an int, or a (B,) int32 tensor on q's
    device).  Returns (B, 1, H, D) in q's dtype."""
    b, _, h, d = q.shape
    if not isinstance(length, torch.Tensor) or length.dim() == 0:
        length = torch.full((b,), int(length), dtype=torch.int32,
                            device=q.device)
    if resolve_backend("auto", q.device) == "cuda":
        ident = torch.arange(b, dtype=torch.int32, device=q.device)
        out = paged_attention_cuda(q[:, 0], k_cache, v_cache,
                                   ident.view(b, 1), length.to(torch.int32))
        return out.view(b, 1, h, d)
    kh = k_cache.shape[2]
    smax = k_cache.shape[1]
    qg = q.reshape(b, kh, h // kh, d).to(torch.float32) * d ** -0.5
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(torch.float32))
    pos = torch.arange(smax, device=q.device)
    sc = torch.where(pos[None, None, None, :] < length.view(b, 1, 1, 1), sc,
                     NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, d).to(q.dtype)
