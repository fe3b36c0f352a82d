"""Mamba-2 SSD (state-space duality) layer (port of ``repro.models.ssm``;
Dao & Gu, arXiv:2405.21060 §6): the chunked algorithm, quadratic within a
chunk and linear across chunks, for prefill; the O(1) recurrence for
decode; and the sequential oracle ``ssd_naive``.

The recurrence across chunks is ``common.associative_scan`` over the chunk
axis (the reference's ``lax.associative_scan``).  Everything runs in f32
on tensors; the output is rounded once to the input's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import associative_scan

__all__ = ["ssd_chunked", "ssd_decode_step", "ssd_naive"]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., L) -> (..., L, L): out[i, j] = sum(a[j+1..i]) for j <= i,
    -inf above the diagonal."""
    n = a.shape[-1]
    cs = torch.cumsum(a, -1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=a.device))
    return torch.where(mask, d, -torch.inf)


def _chunk_comb(left, right):
    s_l, a_l = left
    s_r, a_r = right
    return s_r + s_l * torch.exp(a_r)[..., None, None], a_l + a_r


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int = 256):
    """SSD forward.

    x: (b, s, h, p) inputs per head; dt: (b, s, h) softplus-activated step
    sizes; A: (h,) negative decay rates; B, C: (b, s, g, n) (g groups
    broadcast to h); D: (h,) skip.  s must be a multiple of min(chunk, s).
    Returns (y (b, s, h, p) in x's dtype, final_state (b, h, p, n) f32).
    """
    f32 = torch.float32
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    L = min(chunk, s)
    nc = s // L
    rep = h // g
    a = (dt * A[None, None, :]).to(f32)                     # (b,s,h)
    xb = (x * dt[..., None]).to(f32)
    Bc = B.repeat_interleave(rep, dim=2).to(f32)            # (b,s,h,n)
    Cc = C.repeat_interleave(rep, dim=2).to(f32)
    ar = a.reshape(b, nc, L, h)
    xr = xb.reshape(b, nc, L, h, p)
    Br = Bc.reshape(b, nc, L, h, n)
    Cr = Cc.reshape(b, nc, L, h, n)
    # 1. intra-chunk (quadratic): y_diag = (C B^T * decay) x
    ldec = torch.exp(_segsum(ar.permute(0, 1, 3, 2)))       # (b,nc,h,L,L)
    scores = torch.einsum("bclhn,bcshn->bchls", Cr, Br)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * ldec, xr)
    del ldec, scores
    # 2. chunk-final states: decay-weighted input summary of each chunk
    a_cum = torch.cumsum(ar, 2)                             # (b,nc,L,h)
    a_tail = a_cum[:, :, -1:, :] - a_cum
    states = torch.einsum("bclhn,bclhp->bchpn",
                          Br * torch.exp(a_tail)[..., None], xr)
    # 3. recurrence across chunks
    a_tot = a_cum[:, :, -1, :]                              # (b,nc,h)
    st_in, _ = associative_scan(_chunk_comb, (states, a_tot), dim=1)
    st_prev = torch.cat([torch.zeros_like(st_in[:, :1]), st_in[:, :-1]], 1)
    # 4. contribution of the state entering each chunk
    y_off = torch.einsum("bclhn,bchpn->bclhp",
                         Cr * torch.exp(a_cum)[..., None], st_prev)
    y = (y_diag + y_off).reshape(b, s, h, p)
    y = y + x.to(f32) * D[None, None, :, None]
    return y.to(x.dtype), st_in[:, -1]


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t, D):
    """One recurrent step.  state: (b, h, p, n) f32; x_t: (b, h, p); dt_t:
    (b, h); B_t/C_t: (b, g, n).  Returns (y_t (b, h, p), state')."""
    f32 = torch.float32
    rep = x_t.shape[1] // B_t.shape[1]
    Bh = B_t.repeat_interleave(rep, dim=1).to(f32)          # (b,h,n)
    Ch = C_t.repeat_interleave(rep, dim=1).to(f32)
    da = torch.exp((dt_t * A[None, :]).to(f32))             # (b,h)
    xs = (x_t * dt_t[..., None]).to(f32)                    # (b,h,p)
    state = state * da[..., None, None] + xs[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = y + x_t.to(f32) * D[None, :, None]
    return y.to(x_t.dtype), state


def ssd_naive(x, dt, A, B, C, D):
    """O(S) sequential oracle: ``ssd_decode_step`` over every position."""
    b, s, h, p = x.shape
    state = torch.zeros((b, h, p, B.shape[3]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        y, state = ssd_decode_step(state, x[:, t], dt[:, t], A, B[:, t],
                                   C[:, t], D)
        ys.append(y)
    return torch.stack(ys, 1), state
