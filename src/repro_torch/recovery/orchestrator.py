"""Recovery orchestration (port of ``repro.recovery.orchestrator``): drive a
window stream through CN crashes and MN replica deaths, and summarize the
recovery bill.

``run_recovery`` is the single-device path: one ``runner.run_windows`` loop
with the liveness plane attached, returning the per-window I/O bill (the
``repair_cas`` / ``orphan_windows`` trajectories are what time-to-repair is
read from).

``run_recovery_replicated`` splits the stream at the replica deaths of an
:class:`~repro_torch.recovery.liveness.MNLiveness` schedule, runs each
segment at its surviving replica count, and promotes a survivor between
segments (``dist.store.promote_replica``).  The previous segment's last
alive row is threaded into the next segment (``prev_alive``), so CN crashes
at the failover boundary still strand locks.  Segment outputs are
concatenated on the device.

``run_recovery_sharded`` runs a slot-partitioned store on a local mesh
(``launch.mesh.make_local_mesh``) and splits the stream at each shard
failover, re-owning the dead shards' partitions onto the survivors
(``dist.store.failover_reown``) between segments.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import runner
from repro_torch.core.credits import CreditState
from repro_torch.core.engine import Results, StoreState
from repro_torch.core.runner import WindowStream
from repro_torch.core.types import EngineConfig, IOMetrics, to_numpy
from repro_torch.dist import store as dstore
from repro_torch.launch.mesh import make_local_mesh

__all__ = ["FailoverEvent", "RecoveryRun", "run_recovery",
           "run_recovery_replicated", "run_recovery_sharded", "slice_stream",
           "time_to_repair"]


@dataclasses.dataclass(frozen=True)
class FailoverEvent:
    """At ``window``, the complement of ``survivors`` dies and its slot
    partition is re-owned: windows ``>= window`` run on ``len(survivors)``
    shards.  ``survivors`` are shard ids of the *preceding* topology."""
    window: int
    survivors: tuple[int, ...]


@dataclasses.dataclass
class RecoveryRun:
    """One orchestrated run: per-window results/bill plus the recovery
    control-plane costs."""
    results: Results       # (W, B) stacked
    io: IOMetrics          # per-window bill, leaves (W,)
    state: StoreState
    credits: CreditState
    valid: np.ndarray      # (W, B) post-drop validity (latency masking)
    n_shards: int          # final shard count (1 on the single-device path)
    recovery_io: list[dict]  # one dict per failover or promotion

    def io_sum(self) -> IOMetrics:
        return IOMetrics(*(getattr(self.io, f.name).sum(0, dtype=torch.int32)
                           for f in dataclasses.fields(IOMetrics)))


def _map(fn, tree: Any) -> Any:
    """Apply ``fn`` to every tensor of a (nested) dataclass of tensors."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(*(_map(fn, getattr(tree, f.name))
                            for f in dataclasses.fields(tree)))
    return fn(tree)


def _cat(trees: list) -> Any:
    """Concatenate equal dataclasses of tensors along axis 0, on device."""
    if len(trees) == 1:
        return trees[0]
    cls = type(trees[0])
    return cls(*(torch.cat([getattr(t, f.name) for t in trees])
                 for f in dataclasses.fields(cls)))


def slice_stream(stream: WindowStream, lo: int, hi: int) -> WindowStream:
    """Windows ``[lo, hi)`` of a stream (every leaf's leading axis)."""
    return _map(lambda x: x[lo:hi], stream)


def _post_drop_valid(stream: WindowStream) -> np.ndarray:
    alive, cn = stream.alive, stream.batch.cn
    w = alive.shape[0]
    rows = torch.arange(w, device=alive.device)[:, None]
    live = alive[rows, torch.clamp(cn, 0, alive.shape[1] - 1).long()]
    return to_numpy(stream.valid & live)


def run_recovery(cfg: EngineConfig, state: StoreState, credits: CreditState,
                 stream: WindowStream) -> RecoveryRun:
    """Single-device reference run."""
    state, credits, res, io = runner.run_windows(cfg, state, credits, stream,
                                                 io_per_window=True)
    return RecoveryRun(results=res, io=io, state=state, credits=credits,
                       valid=_post_drop_valid(stream), n_shards=1,
                       recovery_io=[])


def run_recovery_sharded(cfg: EngineConfig, n_shards: int, state: StoreState,
                         credits: CreditState, stream: WindowStream,
                         failovers: Sequence[FailoverEvent] = (),
                         ) -> RecoveryRun:
    """Sharded run with elastic membership, every segment on a local mesh
    of the state's device.

    ``state`` must be an ``n_shards``-way store (``sharded_store_init`` /
    ``sharded_populate``); each failover's survivor count must divide
    ``cfg.n_slots``/``cfg.heap_slots`` (``dstore.shard_extents``).  Between
    segments ``dstore.failover_reown`` rebuilds the store over the
    survivors and bills the rebuild into ``recovery_io``; the replicated
    credit table and the last alive row carry over.
    """
    w = stream.shape[0]
    evs = sorted(failovers, key=lambda e: e.window)
    if any(not 0 < e.window <= w for e in evs):
        raise ValueError(f"failover windows must lie in (0, {w}]")
    bounds = [0] + [e.window for e in evs] + [w]
    if len(set(bounds)) != len(bounds):
        raise ValueError("failover windows must be distinct and interior")
    ress, ios, recovery_io = [], [], []
    prev_alive = None
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        if i > 0:
            state, rio = dstore.failover_reown(cfg, n_shards, state,
                                               evs[i - 1].survivors)
            rio["window"] = evs[i - 1].window
            recovery_io.append(rio)
            n_shards = len(evs[i - 1].survivors)
        seg = slice_stream(stream, lo, hi)
        mesh = make_local_mesh(data=n_shards, device=state.ptr.device)
        state, credits, res, io = dstore.run_windows_sharded(
            cfg, mesh, state, credits, seg, io_per_window=True,
            prev_alive=prev_alive)
        prev_alive = seg.alive[-1]
        ress.append(res)
        ios.append(io)
    return RecoveryRun(results=_cat(ress), io=_cat(ios), state=state,
                       credits=credits, valid=_post_drop_valid(stream),
                       n_shards=n_shards, recovery_io=recovery_io)


def run_recovery_replicated(cfg: EngineConfig, state: StoreState,
                            credits: CreditState, stream: WindowStream,
                            mn: "object") -> RecoveryRun:
    """Replicated-MN run with fail-stop replica deaths (DESIGN.md §13).

    ``mn`` is a :class:`repro_torch.recovery.liveness.MNLiveness` whose
    ``n_replicas`` must equal ``cfg.n_replicas`` and whose ``windows`` must
    match the stream.  The stream is split at ``mn.segments()`` and each
    segment runs at that segment's surviving replica count
    (``dataclasses.replace(cfg, n_replicas=...)``).  Between segments
    ``dist.store.promote_replica`` promotes the lowest surviving replica and
    bills its lock-plane sweep into ``recovery_io`` (control plane, OUT of
    ``IOMetrics``).  The previous segment's last alive row threads through
    (``prev_alive``), so a CN crash at the MN-failover boundary still
    strands locks.

    Because promotion moves no data, the concatenated per-window results
    and data-plane bill equal running the same segments directly through
    ``run_windows`` with the ``n_replicas`` swap and no promotion.
    """
    w = stream.shape[0]
    if mn.windows != w:
        raise ValueError(f"MNLiveness covers {mn.windows} windows, "
                         f"stream has {w}")
    if mn.n_replicas != cfg.n_replicas:
        raise ValueError(f"MNLiveness has {mn.n_replicas} replicas, "
                         f"cfg.n_replicas={cfg.n_replicas}")
    segs = mn.segments()
    ress, ios, recovery_io = [], [], []
    prev_alive = None
    prev_survivors = segs[0][2]
    for i, (lo, hi, survivors) in enumerate(segs):
        if i > 0:
            dead = tuple(sorted(set(prev_survivors) - set(survivors)))
            state, rio = dstore.promote_replica(cfg, state, survivors, dead)
            rio["window"] = lo
            recovery_io.append(rio)
        seg = slice_stream(stream, lo, hi)
        seg_cfg = dataclasses.replace(cfg, n_replicas=len(survivors))
        state, credits, res, io = runner.run_windows(
            seg_cfg, state, credits, seg, io_per_window=True,
            prev_alive=prev_alive)
        prev_alive = seg.alive[-1]
        prev_survivors = survivors
        ress.append(res)
        ios.append(io)
    return RecoveryRun(results=_cat(ress), io=_cat(ios), state=state,
                       credits=credits, valid=_post_drop_valid(stream),
                       n_shards=1, recovery_io=recovery_io)


def time_to_repair(io: IOMetrics, crash_window: int | None) -> dict:
    """Repair timeline out of a per-window bill.

    ``windows_to_repair``: windows from the first crash until the last
    repair activity (a break CAS fired, or an orphaned lock still
    outstanding at window end) — 1 means every strand was broken within the
    crash window itself.  ``stranded_final`` counts locks still orphaned at
    stream end: lazily-repaired slots nobody locked again (harmless to
    optimistic traffic — CIDER's case — but reported, not hidden).
    """
    rc = to_numpy(io.repair_cas)
    ow = to_numpy(io.orphan_windows)
    if crash_window is None:
        return {"windows_to_repair": 0, "repair_cas": int(rc.sum()),
                "orphan_slot_windows": int(ow.sum()), "stranded_final": 0}
    act = np.flatnonzero((rc > 0) | (ow > 0))
    act = act[act >= crash_window]
    last = int(act[-1]) if act.size else crash_window - 1
    return {
        "windows_to_repair": max(last - crash_window + 1, 0),
        "repair_cas": int(rc.sum()),
        "orphan_slot_windows": int(ow.sum()),
        "stranded_final": int(ow[-1]),
    }
