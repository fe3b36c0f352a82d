"""Sequential (single-client) oracle for the KV store semantics (port of
``repro.core.oracle``; numpy and a dict, no tensors).

Applies ops strictly in batch-position order — the ground truth every
synchronization mode must match, SCAN included.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import OpKind

__all__ = ["OracleStore"]


class OracleStore:
    def __init__(self):
        self.kv: dict[int, int] = {}
        self.rows = np.zeros(0, np.int64)   # per-op SCAN row counts, last apply

    def populate(self, keys, values):
        for k, v in zip(np.asarray(keys).tolist(), np.asarray(values).tolist()):
            self.kv[int(k)] = int(v)

    def apply(self, kinds, keys, values, valid=None, scan_max=None):
        """Returns (ok[B], value[B]) per op, mutating the store.

        SCAN ops (count in ``values``, optionally clipped to ``scan_max`` —
        the engine's static probe bound) leave ``value`` at -1 and record
        their found-row counts in ``self.rows`` (B,), 0 for point ops, to
        match ``engine.Results.rows``.
        """
        kinds = np.asarray(kinds)
        keys = np.asarray(keys)
        values = np.asarray(values)
        b = kinds.shape[0]
        if valid is None:
            valid = np.ones(b, bool)
        ok = np.zeros(b, bool)
        out = np.full(b, -1, np.int64)
        self.rows = np.zeros(b, np.int64)
        for i in range(b):
            if not valid[i] or kinds[i] == OpKind.NOP:
                continue
            k, v = int(keys[i]), int(values[i])
            if kinds[i] == OpKind.SEARCH:
                if k in self.kv:
                    ok[i] = True
                    out[i] = self.kv[k]
            elif kinds[i] == OpKind.INSERT:
                if k not in self.kv:
                    ok[i] = True
                    self.kv[k] = v
            elif kinds[i] == OpKind.UPDATE:
                if k in self.kv:
                    ok[i] = True
                    self.kv[k] = v
            elif kinds[i] == OpKind.DELETE:
                if k in self.kv:
                    ok[i] = True
                    del self.kv[k]
            elif kinds[i] == OpKind.SCAN:
                count = v if scan_max is None else min(v, int(scan_max))
                rows = sum(1 for kk in range(k, k + count) if kk in self.kv)
                self.rows[i] = rows
                ok[i] = rows > 0
        return ok, out

    def view(self, n_slots):
        exists = np.zeros(n_slots, bool)
        val = np.full(n_slots, -1, np.int64)
        for k, v in self.kv.items():
            if 0 <= k < n_slots:
                exists[k] = True
                val[k] = v
        return exists, val
