"""The serving-side CIDER integration (port of ``repro.serving.pagetable``):
a prefix-cache page table run by the port's CIDER engine.

Page-table entries are data pointers: key = hash of a prefix block of
tokens, value = page id in the paged KV pool.  Serving workers SEARCH
(prefix hit), INSERT (publish a prefilled page) and DELETE (evict) against
one shared table with extreme skew (everyone shares the system prompt), so
the table is a ``PointerArray`` under ``SyncMode.CIDER``: hot publishes are
write-combined, cold entries stay optimistic.  The engine runs on the
table's device (its ``wc_combine`` kernel on a card); keys and results
cross to the host as numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import IOMetrics, OpBatch, OpKind, SyncMode, to_numpy
from repro_torch.stores.pointer_array import PointerArray

__all__ = ["PageTable"]


def _prefix_hash(tokens: np.ndarray) -> int:
    h = 1469598103934665603
    for t in tokens.tolist():
        h = ((h ^ (t + 1)) * 1099511628211) & 0x7FFFFFFF
    return h


@dataclasses.dataclass
class PageTable:
    store: PointerArray
    block_tokens: int               # tokens per prefix block (== page size)

    @staticmethod
    def create(n_slots: int = 1 << 16, block_tokens: int = 16,
               mode: SyncMode = SyncMode.CIDER,
               device: str | torch.device = "cuda") -> "PageTable":
        return PageTable(store=PointerArray.create(n_slots, mode=mode,
                                                   device=device),
                         block_tokens=block_tokens)

    @property
    def device(self) -> torch.device:
        return self.store.state.ptr.device

    def block_keys(self, tokens: np.ndarray) -> np.ndarray:
        """Rolling prefix-block keys for a token sequence."""
        n = len(tokens) // self.block_tokens
        return np.asarray([_prefix_hash(tokens[:(i + 1) * self.block_tokens])
                           % self.store.cfg.n_slots for i in range(n)],
                          np.int32)

    def _apply(self, kind: OpKind, keys, values, n_cns: int = 1):
        keys = np.asarray(keys, np.int32)
        kinds = np.full(keys.shape[0], kind, np.int32)
        batch = OpBatch.make(kinds, keys, np.asarray(values, np.int32),
                             n_cns=n_cns, device=self.device)
        self.store, res, io = self.store.apply(batch)
        return res, io

    def lookup(self, keys) -> tuple[np.ndarray, np.ndarray, IOMetrics]:
        """Batch SEARCH: returns (page_ids, hit_mask, io)."""
        res, io = self._apply(OpKind.SEARCH, keys, np.zeros(len(keys)))
        return to_numpy(res.value), to_numpy(res.ok), io

    def publish(self, keys, pages, n_cns: int = 1
                ) -> tuple[np.ndarray, IOMetrics]:
        """Batch INSERT of freshly prefilled pages (combined under CIDER)."""
        res, io = self._apply(OpKind.INSERT, keys, pages, n_cns=n_cns)
        return to_numpy(res.ok), io

    def evict(self, keys) -> tuple[np.ndarray, IOMetrics]:
        res, io = self._apply(OpKind.DELETE, keys, np.zeros(len(keys)))
        return to_numpy(res.ok), io
