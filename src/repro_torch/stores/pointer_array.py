"""The pointer-array micro-benchmark store (§5.2; port of
``repro.stores.pointer_array``): key i *is* slot i, one pointer READ of
index I/O per op; point ops only (SCAN is rejected)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import engine, runner
from repro_torch.core.credits import CreditState, credit_init
from repro_torch.core.types import (EngineConfig, OpBatch, OpKind, SyncMode,
                                    UnsupportedOpError)

__all__ = ["PointerArray"]


def _reject_scan(kinds: torch.Tensor) -> None:
    """Point-op stores cannot serve range reads — fail loudly, not with a
    silent 0-row result."""
    if bool((kinds == OpKind.SCAN).any()):
        raise UnsupportedOpError(
            "PointerArray is a point-op object store: it has no key order, "
            "so SCAN has no contiguous leaf run to traverse.  Range reads "
            "need the radix index (repro_torch.stores.SmartART), whose leaf "
            "entries sit in key order.")


@dataclasses.dataclass
class PointerArray:
    cfg: EngineConfig
    state: engine.StoreState
    credits: CreditState

    @staticmethod
    def create(n_keys: int, mode: SyncMode = SyncMode.CIDER,
               heap_slots: int | None = None, credit_table: int = 4096,
               device: str | torch.device = "cuda", **kw) -> "PointerArray":
        cfg = EngineConfig(n_slots=n_keys, heap_slots=heap_slots or 4 * n_keys,
                           mode=mode, index_read_iops=1, index_read_bytes=8,
                           **kw)
        return PointerArray(cfg=cfg, state=engine.store_init(cfg, device),
                            credits=credit_init(credit_table, device))

    def populate(self, keys, values) -> "PointerArray":
        state = engine.populate(self.cfg, self.state, keys, values)
        return dataclasses.replace(self, state=state)

    def apply(self, batch: OpBatch):
        _reject_scan(batch.kinds)
        state, credits, res, io = engine.apply_batch(
            self.cfg, self.state, self.credits, batch)
        return dataclasses.replace(self, state=state, credits=credits), res, io

    def apply_stream(self, stream: runner.WindowStream,
                     io_per_window: bool = False):
        """Run every window of ``stream`` (``runner.run_windows``)."""
        _reject_scan(stream.batch.kinds)
        state, credits, res, io = runner.run_windows(
            self.cfg, self.state, self.credits, stream,
            io_per_window=io_per_window)
        return dataclasses.replace(self, state=state, credits=credits), res, io

    def view(self):
        return engine.store_view(self.state)
