"""Liveness schedules — the control plane of the engine path's failure model
(port of ``repro.recovery.liveness``: the same numpy builders, identical
arrays).

A :class:`LivenessSchedule` is a ``(W, n_cns)`` boolean matrix: row ``w``
masks the compute nodes alive through synchronization window ``w``.  It is
the single source of truth the whole recovery stack derives from:

* ``runner.make_stream(..., alive=sched.alive)`` threads it through the
  window loop, where the engine drops dead CNs' ops at the window boundary
  and strands their in-flight locks (``engine.apply_batch`` step 5b);
* ``sched.drop_mask(...)`` reproduces the per-op validity the engine
  applied, for host-side metrics (``runner.modeled_latency`` masking);
* ``sched.died()`` exposes the crash edges (alive -> dead transitions) that
  scenario generators and tests reason about.

Builders cover the membership patterns the recovery scenarios need:
``crash`` (CNs die at a window and stay dead), ``rolling`` (staggered
down-for-k-windows restarts), and ``elastic`` (arbitrary join/leave event
lists).  Rejoin needs no special handling anywhere downstream: a returning
CN simply starts issuing ops again (the store and the replicated credit
table were never CN-local state).

Memory-node liveness (replication, DESIGN.md §13): :class:`MNLiveness` is
the same idea on the *memory* side — a ``(W, n_replicas)`` mask over the
replica MNs a SNAPSHOT-replicated store writes to.  Unlike CNs, MN replicas
are fail-stop with no rejoin (a returning replica would need an
anti-entropy resync the cost model does not bill), and at least one replica
must survive every window; the schedule's ``segments()`` are what
``orchestrator.run_recovery_replicated`` splits the stream at, re-running
each segment at the surviving replica count.

DESIGN.md §8.1 (the liveness plane): (W, n_cns) alive-mask schedules with
crash/rolling/elastic builders.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["LivenessSchedule", "always_alive", "crash", "rolling", "elastic",
           "MNLiveness", "mn_always_alive", "mn_crash"]


@dataclasses.dataclass(frozen=True)
class LivenessSchedule:
    """Per-window CN liveness. ``alive[w, c]``: CN ``c`` lives through
    window ``w``."""
    alive: np.ndarray          # (W, n_cns) bool

    def __post_init__(self):
        a = np.asarray(self.alive, bool)
        if a.ndim != 2:
            raise ValueError(f"alive must be (W, n_cns), got {a.shape}")
        object.__setattr__(self, "alive", a)

    @property
    def windows(self) -> int:
        return self.alive.shape[0]

    @property
    def n_cns(self) -> int:
        return self.alive.shape[1]

    def died(self) -> np.ndarray:
        """(W, n_cns) crash edges: CN alive at window start, dead through the
        window.  Row 0 is all-False by convention — nothing was in flight
        before the stream began (``runner._prev_alive``)."""
        prev = np.vstack([self.alive[:1], self.alive[:-1]])
        return prev & ~self.alive

    def n_alive(self) -> np.ndarray:
        return self.alive.sum(axis=1)

    def cn_of(self, n_ops: int, lanes_per_cn: int | None = None) -> np.ndarray:
        """(B,) CN id per batch lane — the exact ``OpBatch.make`` assignment."""
        pos = np.arange(n_ops)
        if lanes_per_cn is None:
            lanes_per_cn = max(n_ops // max(self.n_cns, 1), 1)
        return (pos // lanes_per_cn) % max(self.n_cns, 1)

    def drop_mask(self, n_ops: int, lanes_per_cn: int | None = None
                  ) -> np.ndarray:
        """(W, B) per-op liveness: True where the issuing CN is alive — the
        mask the engine AND-ed into ``valid`` (dead lanes never complete)."""
        return self.alive[:, self.cn_of(n_ops, lanes_per_cn)]

    def first_crash_window(self) -> int | None:
        """First window with a crash edge (None if the schedule has none)."""
        rows = np.flatnonzero(self.died().any(axis=1))
        return int(rows[0]) if rows.size else None


@dataclasses.dataclass(frozen=True)
class MNLiveness:
    """Per-window *memory-node replica* liveness (DESIGN.md §13).

    ``alive[w, r]``: replica MN ``r`` serves window ``w``.  Fail-stop with
    no rejoin — a dead replica stays dead (rejoining would require an
    anti-entropy resync the cost model does not bill) — and at least one
    replica survives every window, both enforced at construction.  The CN
    plane (:class:`LivenessSchedule`) rides the stream itself; this plane
    rides the orchestrator, because a replica death changes the *engine
    config* (``EngineConfig.n_replicas``) for every window after it.
    """
    alive: np.ndarray          # (W, n_replicas) bool

    def __post_init__(self):
        a = np.asarray(self.alive, bool)
        if a.ndim != 2:
            raise ValueError(f"alive must be (W, n_replicas), got {a.shape}")
        if not a.any(axis=1).all():
            raise ValueError("every window needs >= 1 surviving replica")
        if (~a[:-1] & a[1:]).any():
            raise ValueError("MN replicas are fail-stop: no rejoin")
        object.__setattr__(self, "alive", a)

    @property
    def windows(self) -> int:
        return self.alive.shape[0]

    @property
    def n_replicas(self) -> int:
        return self.alive.shape[1]

    def died(self) -> np.ndarray:
        """(W, n_replicas) crash edges; row 0 all-False by convention."""
        prev = np.vstack([self.alive[:1], self.alive[:-1]])
        return prev & ~self.alive

    def n_alive(self) -> np.ndarray:
        return self.alive.sum(axis=1)

    def survivors(self, window: int) -> tuple[int, ...]:
        """Replica ids serving ``window``."""
        return tuple(np.flatnonzero(self.alive[window]).tolist())

    def first_crash_window(self) -> int | None:
        rows = np.flatnonzero(self.died().any(axis=1))
        return int(rows[0]) if rows.size else None

    def segments(self) -> list[tuple[int, int, tuple[int, ...]]]:
        """Constant-membership runs ``(lo, hi, survivors)`` covering
        ``[0, W)`` — the split points ``run_recovery_replicated`` re-runs
        the stream at, one ``EngineConfig.n_replicas`` per segment."""
        out, lo = [], 0
        for w in range(1, self.windows):
            if self.died()[w].any():
                out.append((lo, w, self.survivors(lo)))
                lo = w
        out.append((lo, self.windows, self.survivors(lo)))
        return out


def mn_always_alive(windows: int, n_replicas: int) -> MNLiveness:
    return MNLiveness(np.ones((windows, n_replicas), bool))


def mn_crash(windows: int, n_replicas: int, dead_replicas: Sequence[int],
             at_window: int) -> MNLiveness:
    """``dead_replicas`` fail-stop at ``at_window`` and never return."""
    alive = np.ones((windows, n_replicas), bool)
    alive[at_window:, list(dead_replicas)] = False
    return MNLiveness(alive)


def always_alive(windows: int, n_cns: int) -> LivenessSchedule:
    return LivenessSchedule(np.ones((windows, n_cns), bool))


def crash(windows: int, n_cns: int, dead_cns: Sequence[int],
          at_window: int) -> LivenessSchedule:
    """``dead_cns`` crash at ``at_window`` and never return (fail-stop)."""
    alive = np.ones((windows, n_cns), bool)
    alive[at_window:, list(dead_cns)] = False
    return LivenessSchedule(alive)


def rolling(windows: int, n_cns: int, down_windows: int = 2,
            start: int = 1, stagger: int | None = None,
            group: int = 1) -> LivenessSchedule:
    """Rolling restart: CN groups of ``group`` go down for ``down_windows``
    windows each, one group every ``stagger`` windows (default: back to back),
    starting at ``start`` — the whole fleet cycles through a restart."""
    if stagger is None:
        stagger = down_windows
    alive = np.ones((windows, n_cns), bool)
    for g in range((n_cns + group - 1) // group):
        lo = start + g * stagger
        cns = range(g * group, min((g + 1) * group, n_cns))
        alive[lo:lo + down_windows, list(cns)] = False
    return LivenessSchedule(alive)


def elastic(windows: int, n_cns: int,
            events: Sequence[tuple[int, Sequence[int], bool]],
            initial_alive: Sequence[int] | None = None) -> LivenessSchedule:
    """Membership from an event list: each ``(window, cns, alive)`` flips
    the given CNs from that window on.  ``initial_alive`` (default: all)
    sets the starting membership — scale-up scenarios begin with a subset."""
    alive = np.zeros((windows, n_cns), bool)
    cur = np.zeros((n_cns,), bool)
    if initial_alive is None:
        cur[:] = True
    else:
        cur[list(initial_alive)] = True
    evs = sorted(events, key=lambda e: e[0])
    i = 0
    for w in range(windows):
        while i < len(evs) and evs[i][0] == w:
            cur[list(evs[i][1])] = evs[i][2]
            i += 1
        alive[w] = cur
    if i < len(evs):
        raise ValueError(f"event at window {evs[i][0]} beyond {windows} windows")
    return LivenessSchedule(alive)
