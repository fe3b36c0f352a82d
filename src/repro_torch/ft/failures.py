"""Launcher-level fault tolerance (the port's own copy of
``repro.ft.failures``, which imports no JAX; the port imports nothing of
the reference package) — the paper's epoch protocol (§4.6) lifted to the
training fleet.

Each worker FAAs a heartbeat epoch after every step (exactly the lock-epoch
discipline: progress == epoch advance).  The monitor declares a worker dead
when its epoch is stale for ``max_wait_s`` — the deadlock-detection rule —
then shrinks the active set and signals a restore-from-checkpoint onto the
surviving mesh (restore, see ``repro_torch.ckpt``).  A worker that never
beats at all counts as stale from *monitor start*: silence is death, not
innocence (the engine-path analogue is a CN that crashes before its first
epoch FAA — ``repro_torch.recovery``).

Straggler mitigation: per-step deadline = ``straggler_factor`` x that
worker's OWN EWMA step time; a worker that repeatedly misses it is excluded
(same mechanism, softer penalty).  The EWMA is per-worker and deadline-
missing samples are NOT folded into it — a fleet-global EWMA lets one slow
worker inflate the shared average and mask itself, and folding the strike
sample in lets a degrading worker ratchet its own deadline up.
"""
from __future__ import annotations

import dataclasses
import time

__all__ = ["Heartbeat", "FleetMonitor"]


@dataclasses.dataclass
class Heartbeat:
    worker: int
    epoch: int = 0
    t: float = 0.0

    def beat(self, now: float | None = None):
        self.epoch += 1                      # the RDMA_FAA analogue
        self.t = time.monotonic() if now is None else now


class FleetMonitor:
    def __init__(self, n_workers: int, max_wait_s: float = 60.0,
                 straggler_factor: float = 3.0, strikes: int = 3,
                 now: float | None = None):
        t0 = time.monotonic() if now is None else now
        # never-beaten workers age from monitor start (epoch stays 0)
        self.hb = {w: Heartbeat(w, t=t0) for w in range(n_workers)}
        self.max_wait_s = max_wait_s
        self.straggler_factor = straggler_factor
        self.strikes = strikes
        self._miss: dict[int, int] = dict.fromkeys(range(n_workers), 0)
        self._ewma: dict[int, float | None] = dict.fromkeys(range(n_workers))
        self.excluded: set[int] = set()

    def beat(self, worker: int, step_time_s: float | None = None,
             now: float | None = None):
        self.hb[worker].beat(now)
        if step_time_s is None:
            return
        ewma = self._ewma[worker]
        if ewma is not None and step_time_s > self.straggler_factor * ewma:
            # a strike: count it, but keep the sample OUT of the EWMA so the
            # deadline doesn't drift up toward the degraded pace
            self._miss[worker] += 1
            if self._miss[worker] >= self.strikes:
                self.excluded.add(worker)    # straggler: route around it
        else:
            self._ewma[worker] = step_time_s if ewma is None \
                else 0.9 * ewma + 0.1 * step_time_s
            self._miss[worker] = 0

    def dead_workers(self, now: float | None = None) -> list[int]:
        """Epoch stale for max_wait -> deadlock/death declared (§4.6).
        A worker that never beat is stale relative to monitor start."""
        now = time.monotonic() if now is None else now
        return [w for w, h in self.hb.items()
                if w not in self.excluded and now - h.t > self.max_wait_s]

    def active_set(self, now: float | None = None) -> list[int]:
        dead = set(self.dead_workers(now))
        return [w for w in self.hb if w not in dead and w not in self.excluded]
