"""Write-combined sparse embedding gradients (port of
``repro.dist.embed_grad``): the §4.2 combine applied to training.

A token batch updates embedding rows as concurrent KV writers update a
slot: duplicated ids are a wait queue on one row.  The dense gradient
scatters every (token, gradient) pair, T row writes; the combined path
groups the tokens by id with the sort and run sweep of
``core.combine.plan_combine`` and writes one summed row per distinct id,
so the write traffic is proportional to the distinct ids (a heavy-tailed
token distribution makes that a large constant factor).

``combined_embed_grad``: a stable sort by (id, position); the run heads
``is_first`` from the ``wc_combine`` kernel through
``core.combine._first_last_rank`` on a card (its plain version on the
CPU); a cumulative sum of the heads numbers the runs, and a segment sum
(``index_add_`` in f32, cast to the gradients' dtype once) gives each
run's row.  The reference's ``segment_sum`` adds in another order, so
``rows`` agrees with it to summation order; ``hids`` and ``uniq`` are the
same bits.  ``apply_sparse_grad`` writes the representatives' rows into
the table in place (the reference returns a new table; PyTorch saves the
copy) and drops the others, as the reference's ``mode="drop"`` at index
``vocab`` does.
"""
from __future__ import annotations

import torch

from repro_torch.core.combine import _first_last_rank, cumsum_i32, lexsort2

__all__ = ["dense_embed_grad", "combined_embed_grad", "apply_sparse_grad"]


def dense_embed_grad(ids: torch.Tensor, grads: torch.Tensor,
                     vocab: int) -> torch.Tensor:
    """The full (vocab, D) gradient: every token's row added at its id."""
    out = torch.zeros((vocab, grads.shape[-1]), dtype=grads.dtype,
                      device=grads.device)
    return out.index_add_(0, ids.long(), grads)


def combined_embed_grad(ids: torch.Tensor, grads: torch.Tensor):
    """Combine per-token gradients by id: ``(hids, rows, uniq)``, all of
    length T, where ``uniq`` marks one representative per distinct id (the
    first of its run in (id, position) order), ``hids`` holds its id (0
    elsewhere) and ``rows`` its summed gradient (zeros elsewhere).  ids:
    (T,) int32; grads: (T, D)."""
    t = ids.shape[0]
    ids = ids.to(torch.int32)
    pos = torch.arange(t, dtype=torch.int32, device=ids.device)
    order = lexsort2(pos, ids)
    ids_s, g_s = ids[order], grads[order]
    is_first = _first_last_rank(ids_s, "auto")[0]
    seg = (cumsum_i32(is_first) - 1).long()
    summed = torch.zeros((t, grads.shape[-1]), dtype=torch.float32,
                         device=grads.device).index_add_(
                             0, seg, g_s.to(torch.float32))
    rows = torch.where(is_first[:, None], summed[seg],
                       0.0).to(grads.dtype)
    return torch.where(is_first, ids_s, 0), rows, is_first


def apply_sparse_grad(table: torch.Tensor, hids: torch.Tensor,
                      rows: torch.Tensor, uniq: torch.Tensor,
                      lr: float = 1.0) -> torch.Tensor:
    """SGD-apply a combined sparse gradient in place: one row write per
    representative, ``table[hids] += -lr * rows`` in the table's dtype;
    returns ``table``.  The representatives are counted on the host (one
    sync)."""
    sel = uniq.nonzero().squeeze(1)
    upd = -lr * rows[sel].to(table.dtype)
    return table.index_add_(0, hids[sel].long(), upd)
