"""Out-of-place value heap compaction (port of ``repro.stores.heap``).

The engine's heap (``StoreState.heap``) is bump-allocated: the out-of-place
update protocol never reuses a block within a window.  ``reclaim`` compacts
live blocks and rewrites pointers, for long-running loops (DM systems do
this with epoch-based GC off the critical path).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.engine import StoreState
from repro_torch.core.types import NULL_PTR

__all__ = ["reclaim"]


def reclaim(state: StoreState) -> StoreState:
    """Compact the heap: keep only blocks referenced by live pointers, in
    slot order, and leave the logical store view unchanged."""
    live_slots = torch.nonzero(state.ptr != NULL_PTR).squeeze(1)
    heap_slots = state.heap.shape[0]
    n_live = live_slots.shape[0]
    kept = min(n_live, heap_slots)       # blocks past the heap's end drop
    src = torch.clamp(state.ptr[live_slots[:kept]], 0, heap_slots - 1).long()
    heap = torch.full_like(state.heap, -1)
    heap[:kept] = state.heap[src]
    new_ptr = torch.full_like(state.ptr, NULL_PTR)
    new_ptr[live_slots] = torch.arange(n_live, dtype=torch.int32,
                                       device=state.ptr.device)
    return dataclasses.replace(
        state, ptr=new_ptr, heap=heap,
        heap_top=torch.tensor(n_live, dtype=torch.int32,
                              device=state.ptr.device))
