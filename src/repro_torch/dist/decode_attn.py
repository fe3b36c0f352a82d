"""One-token decode attention over a KV cache split along its sequence
(port of ``repro.dist.decode_attn``).

The cache's ``smax`` axis is cut into ``n = mesh.shape[seq_axis]`` equal
parts.  Each part attends over its own rows and keeps its output ``out_r``
and the log-sum-exp ``lse_r`` of its scaled, masked scores; the parts are
then merged by their weights: M = max_r lse_r, w_r = exp(lse_r - M),
out = sum_r w_r out_r / sum_r w_r.  These are the reference's three
collectives (``pmax`` of the running max, ``psum`` of the normaliser and
of the weighted values), folded into each part's (out, lse).

* On one process (``LocalMesh``, or any mesh that is not a process group):
  the cache is viewed as B x n sequences of Smax / n rows (a pool of B x n
  pages under the identity block table) with per-part lengths
  clamp(length - r Smax / n, 0, Smax / n), and one ``paged_attention``
  launch returns every part's (out_r, lse_r); the merge is a reduction
  over the part axis.  On CPU tensors the kernel's plain version,
  ``paged_attention_ref``, computes the same.
* On a ``ProcessGroupMesh`` split along ``data`` (one part a rank): each
  rank attends over its own rows of the (replicated) cache and the merge
  is ``all_reduce`` MAX of lse, then SUM of w out and of w.

Each part's output comes from the kernel in f32, unrounded, and the merge
sums in f32 and rounds once, as the reference does.  A part with no
position (its clamped length 0, the sequence's length >= 1) reads nothing
(the kernel's ``return_lse``): its lse is -inf and its weight 0, as the
reference's masked scores give it.  A sequence of
length <= 0 attends uniformly over the whole cache in the reference (every
score the same -1e30); here each of its parts attends over all its rows
with q = 0 (every score 0), so every part's weight is the same and the
merge is the uniform average.  As in the reference, ``n <= 1`` or an
``smax`` that ``n`` does not divide is plain ``decode_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.core.combine import resolve_backend
from repro_torch.kernels.paged_attention.ops import (paged_attention_cuda,
                                                     paged_attention_ref)
from repro_torch.launch.mesh import ProcessGroupMesh
from repro_torch.models.attention import decode_attention

__all__ = ["decode_attention_spmd"]


def _paged(q, k_pages, v_pages, lengths):
    """(out, lse) of each of the B' sequences of one page each, both f32:
    q (B', H, D), pools (B', rows, KH, D), lengths (B',) int32; a length
    0 reads nothing."""
    bt = torch.arange(q.shape[0], dtype=torch.int32,
                      device=q.device).view(-1, 1)
    fn = paged_attention_cuda if resolve_backend("auto", q.device) == "cuda" \
        else paged_attention_ref
    return fn(q, k_pages, v_pages, bt, lengths, return_lse=True)


def _parts(q, length, offs, rows: int):
    """The query and per-part lengths of the parts starting at ``offs``
    (P,): (B, P, H, D) queries and (B, P) int32 lengths, clamped to each
    part; a sequence of length <= 0 gets every row of every part and q =
    0 (the reference's uniform average)."""
    length = length.to(torch.int32)
    empty = length <= 0
    part_len = (length.view(-1, 1) - offs).clamp(0, rows)
    part_len = torch.where(empty[:, None], rows, part_len).to(torch.int32)
    q = torch.where(empty[:, None, None], 0.0, q[:, 0]).to(q.dtype)
    return q.unsqueeze(1).expand(-1, offs.shape[0], -1, -1), part_len


def decode_attention_spmd(mesh, q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, length, *,
                          seq_axis: str = "model") -> torch.Tensor:
    """q: (B, 1, H, D); caches (B, Smax, KH, D); attend over positions <
    ``length`` (an int, or a (B,) int32 tensor on q's device), the cache's
    sequence split ``mesh.shape[seq_axis]`` ways.  Returns (B, 1, H, D) in
    q's dtype."""
    b, _, h, d = q.shape
    smax, kh = k_cache.shape[1], k_cache.shape[2]
    n = int(mesh.shape[seq_axis])
    if n <= 1 or smax % n:
        return decode_attention(q, k_cache, v_cache, length)
    if not isinstance(length, torch.Tensor) or length.dim() == 0:
        length = torch.full((b,), int(length), dtype=torch.int32,
                            device=q.device)
    rows = smax // n
    if isinstance(mesh, ProcessGroupMesh):
        if seq_axis != "data":
            raise ValueError(f"a process-group mesh splits along 'data', "
                             f"not {seq_axis!r}")
        import torch.distributed as dist
        r = mesh.rank
        sl = slice(r * rows, (r + 1) * rows)
        offs = torch.full((1,), r * rows, dtype=torch.int32, device=q.device)
        q_r, part_len = _parts(q, length, offs, rows)
        out, lse = _paged(q_r[:, 0], k_cache[:, sl], v_cache[:, sl],
                          part_len[:, 0])
        m = lse.clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
        w = torch.exp(lse - m)
        num = w[..., None] * out
        dist.all_reduce(num, op=dist.ReduceOp.SUM)
        dist.all_reduce(w, op=dist.ReduceOp.SUM)
        res = num / w.clamp_min(1e-30)[..., None]
        return res.view(b, 1, h, d).to(q.dtype)
    # every part here: B x n sequences of `rows` rows in one launch
    offs = torch.arange(n, dtype=torch.int32, device=q.device) * rows
    q_rep, part_len = _parts(q, length, offs, rows)
    out, lse = _paged(q_rep.reshape(b * n, h, d),
                      k_cache.reshape(b * n, rows, kh, d),
                      v_cache.reshape(b * n, rows, kh, d),
                      part_len.reshape(b * n))
    lse = lse.view(b, n, h)
    w = torch.exp(lse - lse.amax(1, keepdim=True))          # (B, n, H)
    num = (w[..., None] * out.view(b, n, h, d)).sum(1)
    res = num / w.sum(1).clamp_min(1e-30)[..., None]
    return res.view(b, 1, h, d).to(q.dtype)
