"""Plain PyTorch version of ``paged_attention`` (port of
``repro.kernels.paged_attention.ref``): densify the pages through the block
table, then one masked softmax.  The yardstick the CUDA kernel is held to;
it reads every block-table entry, so entries past a sequence's length must
be valid page ids here."""
from __future__ import annotations

import torch

__all__ = ["paged_attention_ref", "NEG_INF"]

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); k/v_pages: (NPOOL, page, KH, D); block_table: (B, NP)
    page ids; lengths: (B,).  Returns (B, H, D) in q's dtype."""
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
    out = torch.einsum("bkgs,bskd->bkgd", p, vd)
    return out.reshape(b, h, d).to(q.dtype)
