"""SMART-style adaptive radix tree index (Luo et al., OSDI'23; port of
``repro.stores.smart_art``).

The leaf-entry address is the key itself (fixed span, fixed depth), so leaf
entries sit in key order and the key range ``[k, k+c)`` is a contiguous
leaf-slot run — the property SCAN needs, and the reason this store alone
serves ``OpKind.SCAN``.  Per-op index I/O: ``path_misses`` uncached
internal-node READs plus the leaf read.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import engine, runner
from repro_torch.core.credits import CreditState, credit_init
from repro_torch.core.types import (EngineConfig, OpBatch, SyncMode, as_i32)

__all__ = ["SmartART"]


def _radix_slot(keys: torch.Tensor, key_bits: int) -> torch.Tensor:
    """Leaf-entry address of a key: the radix path IS the key."""
    return keys & ((1 << key_bits) - 1)


@dataclasses.dataclass
class SmartART:
    cfg: EngineConfig
    key_bits: int
    state: engine.StoreState
    credits: CreditState

    @staticmethod
    def create(key_bits: int = 20, mode: SyncMode = SyncMode.CIDER,
               path_misses: int = 0, credit_table: int = 4096,
               scan_max: int = 16, device: str | torch.device = "cuda",
               **kw) -> "SmartART":
        n_slots = 1 << key_bits
        cfg = EngineConfig(n_slots=n_slots, heap_slots=4 * n_slots, mode=mode,
                           index_read_iops=1 + path_misses,
                           index_read_bytes=8 + 256 * 8 * path_misses,
                           scan_max=scan_max, **kw)
        return SmartART(cfg=cfg, key_bits=key_bits,
                        state=engine.store_init(cfg, device),
                        credits=credit_init(credit_table, device))

    @property
    def device(self) -> torch.device:
        return self.state.ptr.device

    def slots(self, keys) -> torch.Tensor:
        return _radix_slot(as_i32(keys, self.device), self.key_bits)

    def populate(self, keys, values) -> "SmartART":
        state = engine.populate(self.cfg, self.state, self.slots(keys), values)
        return dataclasses.replace(self, state=state)

    def apply(self, kinds, keys, values, n_cns: int = 1):
        batch = OpBatch.make(kinds, self.slots(keys), values, n_cns=n_cns,
                             device=self.device)
        state, credits, res, io = engine.apply_batch(
            self.cfg, self.state, self.credits, batch)
        return dataclasses.replace(self, state=state, credits=credits), res, io

    def apply_stream(self, kinds, keys, values, n_cns: int = 1,
                     io_per_window: bool = False):
        """Run ``(W, B)`` op arrays: keys resolve through the radix path,
        then ``runner.run_windows`` executes every window."""
        stream = runner.make_stream(kinds, self.slots(keys), values,
                                    n_cns=n_cns, device=self.device)
        state, credits, res, io = runner.run_windows(
            self.cfg, self.state, self.credits, stream,
            io_per_window=io_per_window)
        return dataclasses.replace(self, state=state, credits=credits), res, io

    def view(self):
        return engine.store_view(self.state)
