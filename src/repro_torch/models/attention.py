"""Grouped-query attention (port of ``repro.models.attention``): the
prefill and training path ``gqa_attention`` and the cached one-token path
``decode_attention``, in the reference's layouts.

Each function picks its implementation from the device of its input, in
one place (``core.combine.resolve_backend``): CUDA tensors go to the
hand-written kernels (``flash_attention_cuda``, and ``paged_attention_cuda``
over the dense cache viewed as one page per sequence under the identity
block table), CPU tensors to the plain versions below.  The plain
``gqa_attention`` is the reference's chunked online softmax
(``_flash_fwd_impl``); the plain ``decode_attention`` is its dense masked
softmax.

Training goes through ``_FlashFn``, the counterpart of the reference's
``jax.custom_vjp`` ``_flash``: its forward keeps the O(S) residuals
``(q, k, v, out, lse)``, ``out`` in f32 before its rounding to q's dtype
as in the reference (the backward's delta = rowsum(dout * out) is taken
from it), and its backward is the FlashAttention backward,
which recomputes the scores from them (``flash_attention_bwd_cuda`` on a
card, ``_flash_bwd_plain``, the port of ``_flash_vjp_bwd``, on the CPU).
``gqa_attention`` takes it whenever grad is enabled and an input requires
it; otherwise it runs the forward alone, as serving does.
"""
from __future__ import annotations

import torch

from repro_torch.core.combine import resolve_backend
from repro_torch.dist.ctx import shard
from repro_torch.kernels.flash_attention.ops import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
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
    """Chunked online-softmax forward returning ``(out, lse)``; (b, s, h,
    d) f32 inputs, q scaled; lse (b, s, h) in natural-log units."""
    b, s, h, d = q.shape
    n_q, n_k = s // qc, s // kc
    qr = shard(q.reshape(b, n_q, qc, h, d),
               ("act_batch", None, None, "act_heads", None))
    kr = shard(k.reshape(b, n_k, kc, h, d),
               ("act_batch", None, None, "act_heads", None))
    vr = shard(v.reshape(b, n_k, kc, h, d),
               ("act_batch", None, None, "act_heads", None))
    outs, lses = [], []
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
        lses.append(m_run + torch.log(l_run.clamp_min(1e-30)))
    out = shard(torch.cat(outs, 1), ("act_batch", None, "act_heads", None))
    return out, torch.cat(lses, 1)


def _flash_bwd_plain(q, k, v, out, lse, do, causal, window, qc):
    """FlashAttention backward (``_flash_vjp_bwd``): recompute the scores of
    each query chunk against all S keys from the O(S) residuals.  (b, s, h,
    d) f32 inputs with q scaled and kv heads repeated; returns f32 ``(dq,
    dk, dv)`` with respect to those inputs."""
    b, s, h, d = q.shape
    n_q = s // qc
    do = do.to(torch.float32)
    delta = (do * out).sum(-1)                              # (b, s, h)
    dk = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    k_pos = torch.arange(s, device=q.device)
    for qi in range(n_q):
        sl = slice(qi * qc, (qi + 1) * qc)
        qblk, doblk, lseblk, dblk = q[:, sl], do[:, sl], lse[:, sl], \
            delta[:, sl]
        sc = torch.einsum("bqhd,bshd->bqhs", qblk, k)       # (b, qc, h, S)
        q_pos = qi * qc + torch.arange(qc, device=q.device)
        valid = torch.ones((qc, s), dtype=torch.bool, device=q.device)
        if causal:
            valid &= k_pos[None, :] <= q_pos[:, None]
        if window:
            valid &= k_pos[None, :] > q_pos[:, None] - window
        sc = torch.where(valid[None, :, None, :], sc, NEG_INF)
        p = torch.exp(sc - lseblk[..., None])               # softmax rows
        dv = dv + torch.einsum("bqhs,bqhd->bshd", p, doblk)
        dp = torch.einsum("bqhd,bshd->bqhs", doblk, v)
        ds = p * (dp - dblk[..., None])
        dqs.append(torch.einsum("bqhs,bshd->bqhd", ds, k))
        dk = dk + torch.einsum("bqhs,bqhd->bshd", ds, qblk)
    return torch.cat(dqs, 1), dk, dv


class _FlashFn(torch.autograd.Function):
    """``gqa_attention`` with its FlashAttention backward.  q: (B, S, H, D),
    k/v: (B, S, KH, D), in their own dtype, unscaled and unrepeated; the
    forward saves ``(q, k, v, out, lse)``.  On a card both directions are
    the hand-written kernels; on the CPU the plain chunked versions, with
    the reference's chain rule around its core: q scaled by D^-1/2 (so
    the scale appears in dq), kv heads repeated (so a kv head's dk and dv
    sum over its query heads) and gradients cast back to the inputs'
    dtypes.  Either way the saved ``out`` is the f32 output, before its
    rounding to q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        ctx.causal, ctx.window = causal, window
        if q.device.type == "cuda":
            out, lse, out32 = flash_attention_cuda(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=window, return_lse=True)
            ctx.save_for_backward(q, k, v, out32.transpose(1, 2), lse)
            return out.transpose(1, 2)
        ctx.chunk = min(chunk, q.shape[1])
        out, lse = _flash_fwd_plain(*_core_inputs(q, k, v), causal, window,
                                    ctx.chunk, ctx.chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            # an upstream gradient may be broadcast (stride 0): the kernel
            # reads rows with a contiguous D axis
            dout = dout.contiguous()
            dq, dk, dv = flash_attention_bwd_cuda(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                out.transpose(1, 2), dout.transpose(1, 2), lse,
                causal=ctx.causal, window=ctx.window)
            return (dq.transpose(1, 2), dk.transpose(1, 2),
                    dv.transpose(1, 2), None, None, None)
        b, s, h, d = q.shape
        kh = k.shape[2]
        dq, dk, dv = _flash_bwd_plain(*_core_inputs(q, k, v), out, lse, dout,
                                      ctx.causal, ctx.window, ctx.chunk)
        dk = dk.reshape(b, s, kh, h // kh, d).sum(3)
        dv = dv.reshape(b, s, kh, h // kh, d).sum(3)
        return ((dq * d ** -0.5).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)


def _core_inputs(q, k, v):
    """The f32 inputs of the chunked core: q scaled, kv heads repeated."""
    h, kh, d = q.shape[2], k.shape[2], q.shape[3]
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    k = shard(k, ("act_batch", None, "act_heads", None))
    v = shard(v, ("act_batch", None, "act_heads", None))
    return (q.to(torch.float32) * d ** -0.5, k.to(torch.float32),
            v.to(torch.float32))


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, chunk: int = 1024
                  ) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, S, K, D) with H % K == 0.  Returns
    (B, S, H, D) in q's dtype.  The plain version, like the reference,
    needs S to be a multiple of ``min(chunk, S)``; the kernel takes any S.
    Differentiable through ``_FlashFn`` when grad is enabled and an input
    requires it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashFn.apply(q, k, v, causal, window, chunk)
    if resolve_backend("auto", q.device) == "cuda":
        out = flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window)
        return out.transpose(1, 2)
    c = min(chunk, q.shape[1])
    out, _ = _flash_fwd_plain(*_core_inputs(q, k, v), causal, window, c, c)
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
    sc = shard(sc, ("act_batch", None, None, "act_cache_seq"))
    pos = torch.arange(smax, device=q.device)
    sc = torch.where(pos[None, None, None, :] < length.view(b, 1, 1, 1), sc,
                     NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, d).to(q.dtype)
