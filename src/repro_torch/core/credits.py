"""Contention-aware synchronization: the per-key AIMD credit scheme (§4.3;
port of ``repro.core.credits``).

Decision (Algorithm 1): credit > 0 -> consume one, take the PESSIMISTIC path
(MCS + WC); credit == 0 -> OPTIMISTIC path (out-of-place write + CAS).
Feedback: pessimistic with WC batch > 1 -> credit += 2; WC batch == 1 ->
credit //= AIMD_FACTOR; optimistic with nRetry >= HOTNESS_THRESHOLD twice in
a row -> credit += INITIAL_CREDIT.  The table is direct-mapped (Fibonacci
hash of the key).

Segment reductions run as ``index_add_``/``scatter_reduce_("amax")`` on
int32, exact and order-independent.  One deliberate difference from the
reference: a table slot no lane touched this window promotes nothing.  The
reference's ``segment_max`` fills such slots with INT32_MIN and adds
``INT32_MIN * initial_credit`` (``credits.py:100``), which wraps to 0 only
for an even ``initial_credit``; for an odd one it drives every untouched
slot to -2**31.  The two agree for every even value (the default is 36).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import as_device

__all__ = ["CreditState", "credit_init", "credit_slot", "credit_decide",
           "credit_feedback"]

_I32 = torch.int32
_FIB = 2654435761          # Fibonacci hashing multiplier (uint32)


@dataclasses.dataclass
class CreditState:
    credit: torch.Tensor        # (table,) int32
    retry_record: torch.Tensor  # (table,) int32


def credit_init(table_size: int, device: str | torch.device = "cuda"
                ) -> CreditState:
    dev = as_device(device)
    return CreditState(credit=torch.zeros((table_size,), dtype=_I32, device=dev),
                       retry_record=torch.zeros((table_size,), dtype=_I32,
                                                device=dev))


def credit_slot(keys: torch.Tensor, table_size: int) -> torch.Tensor:
    """Direct-mapped credit-table slot of each key: the reference's uint32
    ``(key * 2654435761) >> 7 % table``, computed exactly in int64 for every
    int32 key (the product is split in 16-bit halves so it never leaves the
    int64 range)."""
    k = keys.to(torch.int64) & 0xFFFFFFFF
    lo, hi = k & 0xFFFF, k >> 16
    h = (lo * _FIB + (((hi * _FIB) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return ((h >> 7) % table_size).to(_I32)


def _segment_max(values: torch.Tensor, slots: torch.Tensor, table_size: int,
                 empty: int) -> torch.Tensor:
    out = torch.full((table_size,), empty, dtype=_I32, device=values.device)
    return out.scatter_reduce_(0, slots, values.to(_I32), "amax",
                               include_self=True)


def credit_decide(state: CreditState, keys, is_write, table_size: int):
    """Algorithm 1 lines 2-6 for a whole batch: ``(state', pessimistic)``.
    Every write to a hot key consumes one credit, floored at 0."""
    slots = credit_slot(keys, table_size).long()
    pess = (state.credit[slots] > 0) & is_write
    dec = torch.zeros((table_size,), dtype=_I32, device=keys.device)
    dec.index_add_(0, slots, pess.to(_I32))
    credit = torch.clamp(state.credit - dec, min=0)
    return dataclasses.replace(state, credit=credit), pess


def credit_feedback(state: CreditState, keys, table_size: int, pess,
                    wc_batch, opt, n_retry, initial_credit: int = 36,
                    hotness_threshold: int = 2,
                    aimd_factor: int = 2) -> CreditState:
    """Algorithm 1 lines 13-16 (pessimistic) and 20-22 (optimistic), batched.
    ``wc_batch``: per-op combined batch size (pessimistic ops);
    ``n_retry``: per-op CAS retry count (optimistic ops)."""
    slots = credit_slot(keys, table_size).long()
    # pessimistic feedback, once per wait queue
    grow = pess & (wc_batch > 1)
    shrink = pess & (wc_batch <= 1)
    inc = _segment_max(torch.where(grow, 2, 0), slots, table_size, 0)
    do_shrink = _segment_max(shrink, slots, table_size, 0)
    do_grow = _segment_max(grow, slots, table_size, 0)
    credit = state.credit + torch.where(do_grow > 0, inc, 0)
    credit = torch.where((do_shrink > 0) & (do_grow == 0),
                         torch.div(credit, aimd_factor, rounding_mode="floor"),
                         credit)
    # optimistic feedback: two consecutive attempts with >= threshold retries
    hot_now = opt & (n_retry >= hotness_threshold)
    prev_hot = state.retry_record[slots] >= hotness_threshold
    promote = _segment_max(hot_now & prev_hot, slots, table_size, 0)
    credit = credit + promote * initial_credit
    # retryRecord <- nRetry of the latest optimistic attempt on this slot
    latest = _segment_max(torch.where(opt, n_retry, -1), slots, table_size, -1)
    retry_record = torch.where(latest >= 0, latest, state.retry_record)
    return CreditState(credit=credit, retry_record=retry_record)
