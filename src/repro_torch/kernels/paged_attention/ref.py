"""Plain PyTorch versions of ``paged_attention``: ``paged_attention_ref``
(port of ``repro.kernels.paged_attention.ref``) densifies the pages through
the block table, then takes one masked softmax, and is the yardstick the
CUDA kernel is held to; ``paged_attention_split_ref`` computes the same
function the way the kernel splits it (per-split partials, then a
log-sum-exp merge).  Both read every block-table entry, so entries past a
sequence's length must be valid page ids here."""
from __future__ import annotations

import torch

__all__ = ["paged_attention_ref", "paged_attention_split_ref", "NEG_INF"]

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        lengths: torch.Tensor, *, return_lse: bool = False):
    """q: (B, H, D); k/v_pages: (NPOOL, page, KH, D); block_table: (B, NP)
    page ids; lengths: (B,).  Returns (B, H, D) in q's dtype.  With
    ``return_lse`` (a part of a split sequence, as in
    ``paged_attention_cuda``): ``(out, lse)``, out in f32, unrounded, lse
    the (B, H) f32 log-sum-exp of each head's scaled, masked scores, and a
    length <= 0 gives out 0 and lse -inf."""
    b, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    np_ = block_table.shape[1]
    g = h // kh
    bt = block_table.long()
    kd = k_pages[bt].reshape(b, np_ * page, kh, d).to(torch.float32)
    vd = v_pages[bt].reshape(b, np_ * page, kh, d).to(torch.float32)
    qg = q.reshape(b, kh, g, d).to(torch.float32) * d ** -0.5
    sc = torch.einsum("bkgd,bskd->bkgs", qg, kd)
    pos = torch.arange(np_ * page, device=q.device)
    valid = pos[None, None, None, :] < lengths.to(q.device)[:, None, None, None]
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, vd).reshape(b, h, d)
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.logsumexp(sc, dim=-1).reshape(b, h)
    empty = lengths.to(q.device)[:, None] <= 0
    return (torch.where(empty[..., None], 0.0, out),
            torch.where(empty, -torch.inf, lse))


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, block_table: torch.Tensor,
                              lengths: torch.Tensor, split: int
                              ) -> torch.Tensor:
    """``paged_attention_ref`` computed as the CUDA kernel splits it: the
    span is cut into splits of ``split`` positions; a split that starts at
    or past a sequence's positions (its length clipped to the span, or the
    whole span for a length <= 0) does not run; the others keep (m, l, acc)
    over their positions, and the output is the sum of the accs weighted by
    exp(m - max m) over the sum of the ls weighted the same way."""
    b, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    np_ = block_table.shape[1]
    g, span = h // kh, np_ * page
    n_split = -(-span // split)
    bt = block_table.long()
    pad = (0, 0, 0, 0, 0, n_split * split - span)
    kd = torch.nn.functional.pad(
        k_pages[bt].reshape(b, span, kh, d).to(torch.float32), pad)
    vd = torch.nn.functional.pad(
        v_pages[bt].reshape(b, span, kh, d).to(torch.float32), pad)
    qg = q.reshape(b, kh, g, d).to(torch.float32) * d ** -0.5
    sc = torch.einsum("bkgd,bskd->bkgs", qg, kd)
    ln = lengths.to(q.device).long()
    n_pos = torch.where(ln >= 1, ln.clamp(max=span), span)
    pos = torch.arange(n_split * split, device=q.device)
    sc = torch.where(pos < ln[:, None, None, None], sc, NEG_INF)
    sc = torch.where(pos < n_pos[:, None, None, None], sc, -torch.inf)
    sc = sc.reshape(b, kh, g, n_split, split)
    m = sc.amax(-1).clamp(min=NEG_INF)
    p = torch.exp(sc - m[..., None])
    l_ = p.sum(-1)
    acc = torch.einsum("bkgns,bnskd->bkgnd", p,
                       vd.reshape(b, n_split, split, kh, d))
    ran = torch.arange(n_split, device=q.device) * split < n_pos[:, None]
    m = torch.where(ran[:, None, None, :], m, -torch.inf)
    w = torch.exp(m - m.amax(-1, keepdim=True))
    den = (l_ * w).sum(-1).clamp(min=1e-30)
    out = (acc * w[..., None]).sum(-2) / den[..., None]
    return out.reshape(b, h, d).to(q.dtype)
