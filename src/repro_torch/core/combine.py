"""Global write-combining as a batched primitive (§4.2; port of
``repro.core.combine``).

The ops that would have formed one MCS wait queue are the ops of the window
that share a key.  A stable sort by (key, queue position) materializes every
wait queue at once; the last element of each run is the executor, everyone
else is combined.  The run sweep over the sorted keys is the ``wc_combine``
kernel (``resolve_backend`` picks the CUDA kernel or its plain version); the
sort itself is ``torch.sort(stable=True)`` either way.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.wc_combine.ops import wc_combine_cuda, wc_combine_ref

__all__ = ["CombinePlan", "plan_combine", "segment_last", "segment_counts",
           "OpStats", "per_key_stats", "stats_from_plan", "GroupPlan",
           "plan_groups", "group_last", "local_executors",
           "local_executors_scatter", "reader_waits", "resolve_backend",
           "lexsort2", "sum_i32", "cumsum_i32"]

_BIG = 2**31 - 1   # invalid-lane sort sentinel
_I32 = torch.int32


def resolve_backend(backend: str, device: torch.device) -> str:
    """``kernel_backend`` -> ``"cuda"`` (the kernel) or ``"torch"`` (the
    plain version) for tensors on ``device``.  ``auto`` runs the kernel on
    CUDA tensors and the plain version on CPU tensors; ``torch`` runs the
    plain version on any device, and exists on a card only so that
    ``chip_smoke.py`` and the ``cuda`` tests can compare the two."""
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "torch":
        return "torch"
    raise ValueError(f"unknown kernel backend {backend!r} "
                     "(expected 'auto' or 'torch')")


def cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum in int32 (torch's default would be int64)."""
    return torch.cumsum(x.to(_I32), 0, dtype=_I32)


def sum_i32(x: torch.Tensor) -> torch.Tensor:
    """0-dim int32 sum, wrapping like the reference's int32 reductions."""
    return x.to(_I32).sum(dtype=_I32)


def _unsort(perm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[perm] = x``: sorted order back to batch order."""
    out = torch.empty_like(x)
    out[perm] = x
    return out


def lexsort2(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((minor, major))``: a stable sort by ``major`` then
    ``minor`` (ties keep index order), as int64 indices.  One stable sort of
    the composite ``major << 32 | (minor + 2**31)``."""
    comp = (major.to(torch.int64) << 32) | (minor.to(torch.int64) + 2**31)
    return torch.sort(comp, stable=True).indices


def _first_last_rank(ks: torch.Tensor, backend: str):
    """Run boundaries + in-run rank of a *sorted* key array through the
    kernel seam: the ``wc_combine`` CUDA kernel or its plain version."""
    if resolve_backend(backend, ks.device) == "cuda":
        return wc_combine_cuda(ks)
    return wc_combine_ref(ks)


def _cummin_reverse(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


@dataclasses.dataclass
class CombinePlan:
    """The materialized wait queues of one window, in sorted order (by key,
    then queue position); ``perm`` maps sorted -> original positions."""
    perm: torch.Tensor          # (B,) int32
    keys_sorted: torch.Tensor   # (B,) int32
    is_first: torch.Tensor      # (B,) bool: run head (the "coordinator")
    is_last: torch.Tensor       # (B,) bool: run tail (the "executor")
    run_length: torch.Tensor    # (B,) int32: my queue length
    rank: torch.Tensor          # (B,) int32: my position within my queue
    n_unique: torch.Tensor      # () int32: distinct valid keys


def plan_combine(keys, pos, valid, *, backend: str = "auto") -> CombinePlan:
    """Build the wait queues of a window: invalid lanes sort to the back on
    the +inf sentinel and form a run callers must mask out."""
    b = keys.shape[0]
    k = torch.where(valid, keys, _BIG)
    order = lexsort2(pos, k)
    ks = k[order]
    is_first, is_last, rank = _first_last_rank(ks, backend)
    idx = torch.arange(b, dtype=_I32, device=keys.device)
    seg_start = idx - rank
    seg_end = _cummin_reverse(torch.where(is_last, idx, _BIG))
    return CombinePlan(
        perm=order.to(_I32), keys_sorted=ks, is_first=is_first,
        is_last=is_last, run_length=seg_end - seg_start + 1, rank=rank,
        n_unique=sum_i32(is_first & valid[order]))


def segment_last(plan: CombinePlan, values):
    """Last-writer-wins combine: ``(unique_keys, winning_values,
    winner_mask_sorted)``, zero beyond the run tails."""
    vs = values[plan.perm]
    return (torch.where(plan.is_last, plan.keys_sorted, 0),
            torch.where(plan.is_last, vs, 0), plan.is_last)


def segment_counts(plan: CombinePlan, valid) -> torch.Tensor:
    """Per-original-op queue length (the paper's "WC batch size")."""
    return _unsort(plan.perm, torch.where(valid[plan.perm], plan.run_length, 0))


@dataclasses.dataclass
class OpStats:
    """Per-original-op wait-queue statistics over a masked op subset."""
    is_tail: torch.Tensor    # (B,) bool — queue tail (the executor)
    mult_of: torch.Tensor    # (B,) int32 — queue length of my key
    rank_of: torch.Tensor    # (B,) int32 — 0-based rank in my queue
    retry_sum: torch.Tensor  # () int32 — sum of ranks


def stats_from_plan(plan: CombinePlan, mask) -> OpStats:
    """Queue statistics for a subset ``mask`` of the plan's valid ops,
    counted inside each run of the existing sort (no second sort)."""
    b = plan.perm.shape[0]
    idx = torch.arange(b, dtype=_I32, device=mask.device)
    perm = plan.perm.long()
    mask_s = mask[perm]
    m_i = mask_s.to(_I32)
    c = cumsum_i32(m_i)               # masked lanes through me, inclusive
    cex = c - m_i                     # masked lanes strictly before me
    seg_start = (idx - plan.rank).long()
    seg_end = (seg_start + plan.run_length.long() - 1)
    rank_s = cex - cex[seg_start]
    mult_s = c[seg_end] - cex[seg_start]
    is_tail_s = mask_s & (c == c[seg_end])
    rank_m = torch.where(mask_s, rank_s, 0)
    return OpStats(is_tail=_unsort(perm, is_tail_s),
                   mult_of=_unsort(perm, torch.where(mask_s, mult_s, 0)),
                   rank_of=_unsort(perm, rank_m),
                   retry_sum=sum_i32(rank_m))


def per_key_stats(keys, pos, mask, *, backend: str = "auto") -> OpStats:
    """Queue statistics per masked op, grouped by key, ordered by ``pos``."""
    return stats_from_plan(plan_combine(keys, pos, mask, backend=backend), mask)


@dataclasses.dataclass
class GroupPlan:
    """(key, compute-node) groups of one window in sorted order: ``perm``
    sorts by (key, cn, pos); ``g_end`` is my group's last sorted index."""
    perm: torch.Tensor    # (B,) int32
    g_end: torch.Tensor   # (B,) int32


def plan_groups(keys, cn, pos, valid) -> GroupPlan:
    """Sort once by (key, cn, pos); invalid lanes form a +inf tail run."""
    k = torch.where(valid, keys, _BIG)
    order = lexsort2(pos, cn)                                   # (cn, pos)
    order = order[torch.sort(k[order], stable=True).indices]   # then key
    ks, cs = k[order], cn[order]
    glast = torch.cat([(ks[1:] != ks[:-1]) | (cs[1:] != cs[:-1]),
                       torch.ones((1,), dtype=torch.bool, device=k.device)])
    idx = torch.arange(k.shape[0], dtype=_I32, device=k.device)
    return GroupPlan(perm=order.to(_I32),
                     g_end=_cummin_reverse(torch.where(glast, idx, _BIG)))


def group_last(gplan: GroupPlan, mask) -> torch.Tensor:
    """Last masked lane of each (key, cn) group, unsorted order."""
    perm = gplan.perm.long()
    mask_s = mask[perm]
    c = cumsum_i32(mask_s)
    return _unsort(perm, mask_s & (c == c[gplan.g_end.long()]))


def local_executors(keys, cn, pos, mask) -> torch.Tensor:
    """Local write combining (§3.1): the last (by ``pos``) masked op of each
    (key, compute-node) group — the only one that leaves the CN."""
    return group_last(plan_groups(keys, cn, pos, mask), mask)


def local_executors_scatter(keys, cn, pos, mask, n_slots: int, n_cns: int,
                            base=0) -> torch.Tensor:
    """Sort-free ``local_executors``: one scatter-max over an
    ``(n_slots * n_cns,)`` cell table, bit-identical under the ``OpBatch``
    contract (``pos`` unique, ``cn`` in ``[0, n_cns)``).  The cell index is
    computed in int64, so it does not wrap at ``n_slots * n_cns >= 2**31``
    as the reference's int32 index does."""
    slot = torch.clamp(keys - base, 0, n_slots - 1).long()
    gi = slot * n_cns + torch.clamp(cn, 0, n_cns - 1).long()
    buf = torch.full((n_slots * n_cns,), -1, dtype=_I32, device=keys.device)
    buf.scatter_reduce_(0, gi, torch.where(mask, pos, -1), "amax",
                        include_self=True)
    return mask & (buf[gi] == pos)


def reader_waits(keys, pos, readers, writers) -> torch.Tensor:
    """Per-reader count of masked writers strictly ahead of it in its key's
    queue (same key, smaller ``pos``); 0 for non-reader lanes."""
    mask = readers | writers
    k = torch.where(mask, keys, _BIG)
    order = lexsort2(pos, k)
    ks = k[order]
    w_s = (writers & mask)[order].to(_I32)
    is_first = torch.cat([torch.ones((1,), dtype=torch.bool, device=k.device),
                          ks[1:] != ks[:-1]])
    excl = cumsum_i32(w_s) - w_s
    base = torch.cummax(torch.where(is_first, excl, 0), 0).values
    return _unsort(order, torch.where(readers[order], excl - base, 0))
