"""Recovery workload generators: op streams PLUS liveness schedules (port of
``repro.workloads.recovery``: identical arrays from identical seeds).

Each scenario emits the pair the recovery stack consumes — a ``(W, B)``
``OpBatchNp`` stream and a :class:`repro_torch.recovery.liveness.LivenessSchedule`
over the same windows — modeled on the failure experiments of FUSEE
(client-crash repair) and DINOMO (elasticity):

* ``crash_storm`` — a fail-stop storm: a fraction of the CNs dies at one
  window and never returns.  The update mix keeps a compact cross-CN hot
  set, so the storm strands locks on queues that surviving writers are
  blocked behind — the §4.6 repair path under maximum pressure.
* ``rolling_restart`` — CN groups go down for a few windows each in a
  staggered wave (a fleet-wide binary rollout): every group's in-flight
  locks strand on the way down, and the group rejoins with no state to
  rebuild (credits and store are global).
* ``elastic_scale`` — membership as capacity management: the stream starts
  on half the CNs, scales up at one window (join strands nothing), then
  scales a quarter back down (leave == planned crash; same repair bill).

Traffic is the same skewed UPDATE/SEARCH mix the dynamic-contention
scenarios use, with the hot set strided across lanes so hot writers span
CNs (otherwise baseline local WC absorbs the queue and nothing strands).

DESIGN.md §8.4 (recovery benchmark): op stream + liveness schedule pairs for
the crash scenarios.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.types import OpKind
from repro_torch.recovery.liveness import (LivenessSchedule, crash, elastic,
                                           rolling)
from repro_torch.workloads.ycsb import OpBatchNp
from repro_torch.workloads.zipf import ZipfSampler

__all__ = ["RecoveryScenario", "RECOVERY_SCENARIOS", "crash_storm",
           "rolling_restart", "elastic_scale"]


def _hot_mix(windows: int, n_ops: int, n_keys: int, n_clients: int,
             seed: int, *, write_ratio: float = 0.6, theta: float = 0.99,
             hot_keys: int = 8, hot_frac: float = 0.5) -> OpBatchNp:
    """Stationary skewed UPDATE/SEARCH mix with a strided cross-CN hot set."""
    rng = np.random.default_rng(seed + 71)
    zipf = ZipfSampler(n_keys, theta, seed=seed)
    keys = zipf.sample(windows * n_ops).reshape(windows, n_ops)
    hot_set = rng.permutation(n_keys)[:hot_keys]
    kinds = np.where(rng.random((windows, n_ops)) < write_ratio,
                     OpKind.UPDATE, OpKind.SEARCH).astype(np.uint8)
    for w in range(windows):
        hot = rng.random(n_ops) < hot_frac
        keys[w, hot] = rng.choice(hot_set, size=int(hot.sum()))
    # stride a hot UPDATE across lanes so every CN carries hot writers
    stride = max(n_ops // 64, 4)
    keys[:, ::stride] = hot_set[0]
    kinds[:, ::stride] = OpKind.UPDATE
    values = rng.integers(1, 2**31 - 1, size=(windows, n_ops), dtype=np.int64)
    clients = np.broadcast_to((np.arange(n_ops) % n_clients).astype(np.int32),
                              (windows, n_ops)).copy()
    return OpBatchNp(kinds=kinds, keys=keys.astype(np.int64), values=values,
                     clients=clients)


def crash_storm(windows: int, n_ops: int, n_keys: int, n_clients: int,
                n_cns: int, seed: int = 0, *, storm_frac: float = 0.25,
                crash_window: int | None = None,
                ) -> tuple[OpBatchNp, LivenessSchedule]:
    """``storm_frac`` of the CNs fail-stop at ``crash_window`` (default
    ``windows // 3``), spread across the CN id space so dead writers land in
    every hot queue."""
    if crash_window is None:
        crash_window = max(windows // 3, 1)
    rng = np.random.default_rng(seed + 101)
    n_dead = max(int(storm_frac * n_cns), 1)
    dead = rng.choice(n_cns, size=n_dead, replace=False)
    ops = _hot_mix(windows, n_ops, n_keys, n_clients, seed)
    return ops, crash(windows, n_cns, dead, crash_window)


def rolling_restart(windows: int, n_ops: int, n_keys: int, n_clients: int,
                    n_cns: int, seed: int = 0, *, down_windows: int = 1,
                    group: int | None = None, start: int = 1,
                    ) -> tuple[OpBatchNp, LivenessSchedule]:
    """Staggered restart wave: groups of ``group`` CNs (default: the fleet
    split over the post-``start`` windows) down ``down_windows`` each."""
    if group is None:
        usable = max(windows - start - down_windows, 1)
        group = max((n_cns * down_windows + usable - 1) // usable, 1)
    ops = _hot_mix(windows, n_ops, n_keys, n_clients, seed)
    return ops, rolling(windows, n_cns, down_windows=down_windows,
                        start=start, group=group)


def elastic_scale(windows: int, n_ops: int, n_keys: int, n_clients: int,
                  n_cns: int, seed: int = 0, *, join_window: int | None = None,
                  leave_window: int | None = None,
                  ) -> tuple[OpBatchNp, LivenessSchedule]:
    """Scale-up then scale-down: start on the first half of the CNs, the
    second half joins at ``join_window``, a quarter leaves at
    ``leave_window``."""
    if join_window is None:
        join_window = max(windows // 3, 1)
    if leave_window is None:
        leave_window = max(2 * windows // 3, join_window + 1)
    half, quarter = n_cns // 2, max(n_cns // 4, 1)
    ops = _hot_mix(windows, n_ops, n_keys, n_clients, seed)
    sched = elastic(
        windows, n_cns,
        events=[(join_window, range(half, n_cns), True),
                (leave_window, range(quarter), False)],
        initial_alive=range(half))
    return ops, sched


@dataclasses.dataclass(frozen=True)
class RecoveryScenario:
    """A registered recovery scenario: ``generate(windows, n_ops, n_keys,
    n_clients, n_cns, seed=0, **overrides) -> (ops, LivenessSchedule)``."""
    name: str
    generate: Callable[..., tuple[OpBatchNp, LivenessSchedule]]
    description: str = ""

    def populate_keys(self, n_keys: int) -> np.ndarray:
        return np.arange(n_keys)


RECOVERY_SCENARIOS = {
    "crash_storm": RecoveryScenario(
        "crash_storm", crash_storm,
        description="a quarter of the CNs fail-stop at one window; their "
                    "in-flight locks strand on the hot queues"),
    "rolling_restart": RecoveryScenario(
        "rolling_restart", rolling_restart,
        description="staggered down-for-k-windows restart wave over the "
                    "whole fleet; every group strands on the way down"),
    "elastic_scale": RecoveryScenario(
        "elastic_scale", elastic_scale,
        description="scale-up (join: strands nothing) then scale-down "
                    "(leave == planned crash: same repair bill)"),
}
