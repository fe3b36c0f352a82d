"""RACE-style two-choice hash index (Zuo et al., ATC'21; port of
``repro.stores.race_hash``).

RACE keeps KV pointers in hash *slots*; lookups read two candidate bucket
groups with one-sided READs and modify slots with RDMA_CAS:

* two candidate buckets per key (h1/h2), ``ways`` slots per bucket;
* SEARCH/UPDATE/DELETE read both bucket groups (2 READs, bucket bytes each);
* INSERT claims a free way in the emptier candidate (two-choice), then runs
  the engine's INSERT on that slot — concurrent same-key INSERTs race on one
  slot (one winner, §4.2.2), concurrent distinct-key INSERTs into one bucket
  claim distinct ways (rank-ordered, as CAS order would).

Table capacity is fixed (no directory doubling); inserts into a full bucket
pair fail with ``overflow``.  SCAN is rejected with ``UnsupportedOpError``:
a hash scatters adjacent keys across unrelated buckets (DESIGN.md §9).

Every ``plan_combine`` here (two in ``_reserve``, one for the batch-local
binding, besides the engine's own) runs the ``wc_combine`` kernel on CUDA
tensors.  The reference hashes in uint32; the port hashes in int64 and
keeps the low 32 bits after each multiply, which are exact.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import combine as wc
from repro_torch.core import engine
from repro_torch.core.credits import CreditState, credit_init
from repro_torch.core.types import (EngineConfig, IOMetrics, OpBatch, OpKind,
                                    SyncMode, UnsupportedOpError, as_i32)

__all__ = ["RaceHash"]

_EMPTY = -1
_I32 = torch.int32
_U32 = 0xFFFFFFFF
_I32_MIN = -2**31


def _h(keys: torch.Tensor, seed: int, n_buckets: int) -> torch.Tensor:
    """The reference's uint32 hash: ``x = u32(key) * seed``, xor-shift 15,
    ``* 0x2C1B3C6D``, xor-shift 12, ``% n_buckets``.  In int64, masked to
    32 bits after each multiply (an int64 product that wraps keeps its low
    32 bits)."""
    x = ((keys.to(torch.int64) & _U32) * seed) & _U32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _U32
    x = x ^ (x >> 12)
    return (x % n_buckets).to(_I32)


def _segment_max(data: torch.Tensor, seg: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """``jax.ops.segment_max(data, seg, num_segments=n)`` for int32: empty
    segments hold INT32_MIN, as the reference's do."""
    out = torch.full((n,), _I32_MIN, dtype=_I32, device=data.device)
    return out.scatter_reduce_(0, seg.long(), data.to(_I32), "amax",
                               include_self=False)


@dataclasses.dataclass
class RaceHash:
    cfg: EngineConfig
    n_buckets: int
    ways: int
    slot_keys: torch.Tensor       # (n_buckets*ways,) stored key or -1
    state: engine.StoreState
    credits: CreditState

    @staticmethod
    def create(capacity: int, mode: SyncMode = SyncMode.CIDER, ways: int = 8,
               credit_table: int = 4096, device: str | torch.device = "cuda",
               **kw) -> "RaceHash":
        n_buckets = max(capacity // ways, 2)
        # +1: a permanently-empty tombstone slot that absent-key SEARCH /
        # UPDATE / DELETE ops resolve to (they must fail, and do — the engine
        # rejects non-INSERT ops on an empty slot)
        n_slots = n_buckets * ways + 1
        cfg = EngineConfig(n_slots=n_slots, heap_slots=4 * n_slots, mode=mode,
                           index_read_iops=2, index_read_bytes=16 * ways, **kw)
        state = engine.store_init(cfg, device)
        return RaceHash(cfg=cfg, n_buckets=n_buckets, ways=ways,
                        slot_keys=torch.full((n_buckets * ways,), _EMPTY,
                                             dtype=_I32,
                                             device=state.ptr.device),
                        state=state,
                        credits=credit_init(credit_table, state.ptr.device))

    @property
    def device(self) -> torch.device:
        return self.slot_keys.device

    # ------------------------------------------------------------------
    def _buckets(self, keys):
        return (_h(keys, 0x9E3779B1, self.n_buckets),
                _h(keys, 0x85EBCA77, self.n_buckets))

    def locate(self, keys) -> tuple[torch.Tensor, torch.Tensor]:
        """Resolve keys to slots: returns (slot, found)."""
        keys = as_i32(keys, self.device)
        b1, b2 = self._buckets(keys)
        w = self.ways
        rows = torch.stack([b1, b2], 1)                     # (B, 2)
        cand = (rows[:, :, None] * w
                + torch.arange(w, dtype=_I32, device=keys.device))
        ck = self.slot_keys[cand.long()]                    # (B, 2, w)
        hit = (ck == keys[:, None, None]).reshape(keys.shape[0], -1)
        found = hit.any(1)
        # the first hit in (bucket 1 ways, bucket 2 ways) order, as
        # jnp.argmax takes the first maximum
        idx = torch.argmax(hit.to(_I32), dim=1)
        slot = torch.gather(cand.reshape(keys.shape[0], -1), 1,
                            idx[:, None])[:, 0]
        return torch.where(found, slot, 0).to(_I32), found

    def _reserve(self, keys, mask):
        """Two-choice slot reservation for INSERTs of not-present keys.
        Same-key ops share one candidate slot; distinct keys claiming one
        bucket get distinct free ways (rank order).  Returns (slot, ok)."""
        b = keys.shape[0]
        w = self.ways
        dev = keys.device
        backend = self.cfg.kernel_backend
        b1, b2 = self._buckets(keys)
        table = self.slot_keys.reshape(self.n_buckets, w)
        occ1 = (table[b1.long()] != _EMPTY).sum(1)
        occ2 = (table[b2.long()] != _EMPTY).sum(1)
        bucket = torch.where(occ2 < occ1, b2, b1)
        # one representative per unique key
        pos = torch.arange(b, dtype=_I32, device=dev)
        plan = wc.plan_combine(keys, pos, mask, backend=backend)
        perm = plan.perm.long()
        rep_sorted = plan.is_first & mask[perm]
        # the reference's .at[perm].set scatters: perm is a permutation, so
        # every index is written exactly once
        rep = wc._unsort(perm, rep_sorted)
        # rank of representatives within their chosen bucket
        rank = wc.per_key_stats(bucket, pos, rep, backend=backend).rank_of
        # rank-th free way of the bucket (ways sorted: free first; the sort
        # keys are distinct within a row, so the order is unique)
        row = table[bucket.long()]                          # (B, w)
        ways = torch.arange(w, dtype=_I32, device=dev)
        way_order = torch.argsort(torch.where(row == _EMPTY, 0, 1) * w + ways,
                                  dim=1)
        n_free = (row == _EMPTY).sum(1)
        ok_rep = rep & (rank < n_free)
        way = torch.gather(way_order, 1,
                           torch.clamp(rank, max=w - 1).long()[:, None])[:, 0]
        slot_rep = bucket * w + way.to(_I32)
        # propagate representative slot to same-key duplicates
        slot_sorted = torch.where(rep_sorted, slot_rep[perm], -1)
        ok_sorted = rep_sorted & ok_rep[perm]
        seg = wc.cumsum_i32(plan.is_first) - 1
        slot_seg = _segment_max(slot_sorted, seg, b)
        ok_seg = _segment_max(ok_sorted.to(_I32), seg, b)
        slot = wc._unsort(perm, slot_seg[seg.long()])
        ok = wc._unsort(perm, ok_seg[seg.long()] > 0)
        return torch.where(mask, slot, 0), ok & mask

    # ------------------------------------------------------------------
    def apply(self, kinds, keys, values, n_cns: int = 1
              ) -> tuple["RaceHash", engine.Results, IOMetrics, torch.Tensor]:
        """Resolve + execute one batch; returns (store', results, io, overflow)."""
        dev = self.device
        kinds = as_i32(kinds, dev)
        if bool((kinds == OpKind.SCAN).any()):
            raise UnsupportedOpError(
                "RaceHash cannot serve SCAN: the hash scatters adjacent keys "
                "across unrelated buckets, so a key range has no contiguous "
                "slot run to traverse.  Use the radix index "
                "(repro_torch.stores.SmartART) for range workloads "
                "(DESIGN.md §9).")
        keys = as_i32(keys, dev)
        values = as_i32(values, dev)
        b = kinds.shape[0]
        pos = torch.arange(b, dtype=_I32, device=dev)
        slot, found = self.locate(keys)
        is_ins = kinds == OpKind.INSERT
        need = is_ins & ~found
        rslot, rok = self._reserve(keys, need)
        overflow = need & ~rok
        # Batch-local binding: every op on an absent key resolves to the slot
        # reserved by that key's INSERT in this batch (serialization inside
        # the engine then gives exact before/after-the-insert semantics);
        # absent keys with no INSERT resolve to the empty tombstone slot.
        plan = wc.plan_combine(keys, pos, ~found,
                               backend=self.cfg.kernel_backend)
        perm = plan.perm.long()
        rs = torch.where(need & rok, rslot, -1)[perm]
        seg = wc.cumsum_i32(plan.is_first) - 1
        rs_seg = _segment_max(rs, seg, b)
        bound = wc._unsort(perm, rs_seg[seg.long()])
        tomb = self.cfg.n_slots - 1
        slot = torch.where(found, slot,
                           torch.where(bound >= 0, bound, tomb)).to(_I32)
        valid = ~overflow
        batch = OpBatch.make(kinds, slot, values, n_cns=n_cns, device=dev)
        state, credits, res, io = engine.apply_batch(
            self.cfg, self.state, self.credits, batch, valid=valid)
        # index maintenance: a successful INSERT binds key -> slot, then a
        # successful DELETE frees the slot.  Indices repeat only where ops
        # of one key share its slot (an INSERT after a DELETE of the same
        # key), and every such write carries the same value (that key, or
        # -1), so which duplicate lands does not matter.
        ok_ins = res.ok & is_ins
        ok_del = res.ok & (kinds == OpKind.DELETE)
        nslots = self.slot_keys.shape[0]
        slot_keys = self.slot_keys.clone()
        sel = ok_ins & (slot < nslots)
        slot_keys[slot[sel].long()] = keys[sel]
        sel = ok_del & (slot < nslots)
        slot_keys[slot[sel].long()] = _EMPTY
        new = dataclasses.replace(self, slot_keys=slot_keys, state=state,
                                  credits=credits)
        return new, res, io, overflow

    def populate(self, keys, values, chunk: int = 8192) -> "RaceHash":
        """Insert ``keys`` -> ``values`` in INSERT batches of ``chunk``
        (the last one padded with NOPs); overflowing keys stay absent."""
        store = self
        keys = as_i32(keys, self.device)
        values = as_i32(values, self.device)
        kinds = torch.full((chunk,), OpKind.INSERT, dtype=_I32,
                           device=self.device)
        for i in range(0, keys.shape[0], chunk):
            k = keys[i:i + chunk]
            v = values[i:i + chunk]
            kd = kinds
            if k.shape[0] < chunk:
                pad = chunk - k.shape[0]
                k = torch.nn.functional.pad(k, (0, pad))
                v = torch.nn.functional.pad(v, (0, pad))
                kd = kinds.clone()
                kd[chunk - pad:] = OpKind.NOP
            store, _, _, _ = store.apply(kd, k, v)
        return store
