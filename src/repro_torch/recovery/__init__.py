"""Crash recovery and MN replication for the port's engine path (port of
``repro.recovery``; DESIGN.md §8, §13).

* **liveness** (:mod:`repro_torch.recovery.liveness`) — per-window CN alive
  masks (``LivenessSchedule``) and MN replica masks (``MNLiveness``);
* **lock repair** — engine step 5b (``repro_torch.core.engine``): orphaned
  pessimistic locks are detected by the next waiter and broken with a
  repair CAS, billed in ``IOMetrics.repair_cas``/``orphan_windows``;
* **orchestration** (:mod:`repro_torch.recovery.orchestrator`) —
  ``run_recovery`` (single device), ``run_recovery_replicated`` (MN
  replica deaths, ``dist.store.promote_replica`` between segments),
  ``run_recovery_sharded`` (shard failover, ``dist.store.failover_reown``
  between segments) and ``time_to_repair``.

Scenario generators live in :mod:`repro_torch.workloads.recovery`.
"""
from repro_torch.recovery.liveness import (LivenessSchedule, MNLiveness,
                                           always_alive, crash, elastic,
                                           mn_always_alive, mn_crash, rolling)
from repro_torch.recovery.orchestrator import (FailoverEvent, RecoveryRun,
                                               run_recovery,
                                               run_recovery_replicated,
                                               run_recovery_sharded,
                                               slice_stream, time_to_repair)

__all__ = [
    "LivenessSchedule", "always_alive", "crash", "rolling", "elastic",
    "MNLiveness", "mn_always_alive", "mn_crash",
    "FailoverEvent", "RecoveryRun", "run_recovery", "run_recovery_replicated",
    "run_recovery_sharded", "slice_stream", "time_to_repair",
]
