"""The sharded CIDER dataplane (port of ``repro.dist.store``): ``StoreState``
partitioned over the shards of a mesh (``repro_torch.launch.mesh``).

Slot ``k`` (and its heap) is owned by shard ``k // slots_per_shard``.  Every
shard sees the whole window, masks the ops whose keys it owns, and runs the
unmodified ``engine.apply_batch`` on its slot/heap partition; the engine's
credit plane runs on the full window on every shard, so the replicated
credit table stays identical everywhere and nothing crosses shards but the
final sum that assembles per-op results and the global I/O bill.

Physical layout, as in the reference: every array keeps its global length;
shard ``s`` owns ``ptr``/``meta``/``epoch`` ``[s*per, (s+1)*per)`` and heap
``[s*hper, (s+1)*hper)``; ``ptr`` holds shard-local heap indices and
``heap_top`` is ``(n_shards,)``.  So a state compares field for field with
the reference's ``sharded_populate`` output.

Equivalence contract (``tests/test_torch_dist_store.py``): for any shard
count that divides ``n_slots``/``heap_slots``, the logical store view,
``ver``/``epoch``, per-op ``Results``, the credit table and every
``IOMetrics`` counter equal the single-device engine's, for all four
``SyncMode``s; only the heap packing differs.

The window loop keeps every shard's per-window partials on its device and
sums them over shards once, after the loop: one ``mesh.reduce`` per
``Results`` and ``IOMetrics`` field, 20 per run, however many windows.
On a process-group mesh each rank runs its own shard, and the returned
store holds that rank's partition (the others' are those passed in).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.credits import CreditState
from repro_torch.core.engine import Results, StoreState
from repro_torch.core.runner import WindowStream, _as_bool
from repro_torch.core.types import (NULL_PTR, EngineConfig, IOMetrics,
                                    OpBatch, OpKind, as_i32, to_numpy)

__all__ = ["shard_extents", "sharded_store_init", "sharded_populate",
           "sharded_store_view", "apply_batch_sharded", "run_windows_sharded",
           "run_windows_sharded_traced", "failover_reown", "promote_replica"]

_NONE = -1
_I32 = torch.int32


def shard_extents(cfg: EngineConfig, n_shards: int) -> tuple[int, int]:
    """(slots_per_shard, heap_per_shard); raises unless both divide evenly."""
    if cfg.n_slots % n_shards or cfg.heap_slots % n_shards:
        raise ValueError(
            f"n_slots={cfg.n_slots} / heap_slots={cfg.heap_slots} must be "
            f"divisible by n_shards={n_shards}")
    return cfg.n_slots // n_shards, cfg.heap_slots // n_shards


def sharded_store_init(cfg: EngineConfig, n_shards: int,
                       device: str | torch.device = "cuda") -> StoreState:
    """Like ``store_init`` but with a per-shard heap bump cursor
    ``(n_shards,)``; ``ptr`` will hold shard-local heap indices."""
    shard_extents(cfg, n_shards)
    st = engine.store_init(cfg, device)
    return dataclasses.replace(
        st, heap_top=torch.zeros((n_shards,), dtype=_I32,
                                 device=st.ptr.device))


def sharded_populate(cfg: EngineConfig, n_shards: int, state: StoreState,
                     keys, values) -> StoreState:
    """Bulk-load distinct KV pairs, packing each shard's heap separately
    (in key-list order within a shard)."""
    per, hper = shard_extents(cfg, n_shards)
    dev = state.ptr.device
    keys = as_i32(keys, dev)
    values = as_i32(values, dev)
    n = keys.shape[0]
    owner = torch.div(keys, per, rounding_mode="floor").long()
    order = torch.sort(owner, stable=True).indices
    counts = torch.bincount(owner, minlength=n_shards).to(_I32)
    start = torch.cumsum(counts, 0, dtype=_I32) - counts
    rank = torch.empty((n,), dtype=_I32, device=dev)
    rank[order] = (torch.arange(n, dtype=_I32, device=dev)
                   - start[owner[order]])
    loc = state.heap_top[owner] + rank                  # shard-local index
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    heap = engine._scatter_set(state.heap, owner.to(_I32) * hper + loc,
                               values, ones)
    ptr = engine._scatter_set(state.ptr, keys, loc, ones)
    return dataclasses.replace(state, ptr=ptr, heap=heap,
                               heap_top=state.heap_top + counts)


def sharded_store_view(cfg: EngineConfig, n_shards: int, state: StoreState
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Logical ``(exists, value)`` view of a sharded store."""
    per, hper = shard_extents(cfg, n_shards)
    owner = torch.div(torch.arange(cfg.n_slots, dtype=_I32,
                                   device=state.ptr.device), per,
                      rounding_mode="floor")
    exists = state.ptr != NULL_PTR
    val = torch.where(
        exists, engine._heap_at(state.heap,
                                owner * hper + torch.clamp(state.ptr, min=0)),
        _NONE)
    return exists, val


def failover_reown(cfg: EngineConfig, n_from: int, state: StoreState,
                   survivors: tuple[int, ...]) -> tuple[StoreState, dict]:
    """Re-own dead shards' slot partitions onto the survivors.

    DINOMO-style elastic failover: the surviving shards reconstruct the lost
    partitions from replicas and re-partition the store over
    ``len(survivors)`` shards (which must divide ``n_slots``/``heap_slots``).
    The logical store — (exists, value) per slot plus the slot-indexed
    ``meta``/``epoch`` planes — carries over; only the heap packing is
    rebuilt, through the host, once per failover.  The replicated credit
    table is global, so the post-failover runner takes the same one.

    Returns ``(new_state, recovery_io)``: ``recovery_io`` is the
    control-plane recovery bill (replica reads that rebuild the lost
    partitions), kept OUT of ``IOMetrics`` so the post-failover data-plane
    bill equals a single-device run with the same CN drop mask.
    """
    n_to = len(survivors)
    per_f, _ = shard_extents(cfg, n_from)
    shard_extents(cfg, n_to)
    dead = sorted(set(range(n_from)) - set(survivors))
    if len(set(survivors)) != n_to or any(s not in range(n_from)
                                          for s in survivors):
        raise ValueError(f"survivors {survivors!r} must be distinct shards "
                         f"of the {n_from}-way store")
    exists, val = (to_numpy(x) for x in sharded_store_view(cfg, n_from,
                                                           state))
    keys = np.flatnonzero(exists)
    dev = state.ptr.device
    new = sharded_populate(cfg, n_to, sharded_store_init(cfg, n_to, dev),
                           keys, val[keys])
    new = dataclasses.replace(new, meta=state.meta.clone(),
                              epoch=state.epoch.clone())
    lost_live = int(exists.reshape(n_from, per_f)[dead].sum()) if dead else 0
    recovery_io = {
        "dead_shards": dead,
        "survivors": list(survivors),
        # one replica READ per lost pointer slot + one per live lost value
        "reown_reads": len(dead) * per_f + lost_live,
        "reown_bytes": (len(dead) * per_f * cfg.ptr_bytes
                        + lost_live * cfg.value_bytes),
    }
    return new, recovery_io


def promote_replica(cfg: EngineConfig, state: StoreState,
                    survivors: tuple[int, ...], dead_replicas: tuple[int, ...],
                    ) -> tuple[StoreState, dict]:
    """Promote a surviving replica MN after replica deaths (DESIGN.md §13).

    SNAPSHOT client-centric replication keeps every replica's logical store
    identical — each acked write hit all R replicas before completing, and
    window-granular execution means no write is mid-fan-out at a window
    boundary — so promotion moves **no data**: clients drop the dead
    replicas from their replica lists and re-point reads at the lowest
    surviving replica.  What failover must still do is re-run the §4.6
    orphaned-lock repair against the promoted replica: every lock the CN
    liveness plane has stranded (``StoreState.stranded``) is re-armed with
    one break CAS on each surviving replica's copy, and the whole lock
    plane is swept (one lock-entry READ per slot) to certify that no
    acquisition was mid-fan-out when the replica died.

    Control-plane only: the returned state is the input state, and the
    sweep's bill is returned as a ``recovery_io`` dict kept OUT of
    ``IOMetrics`` — so the post-failover data-plane bill equals a plain
    segmented run that swaps ``EngineConfig.n_replicas`` at the crash
    window.
    """
    dead = sorted(dead_replicas)
    if not survivors:
        raise ValueError("promote_replica: no surviving replica")
    if set(dead) & set(survivors):
        raise ValueError(f"replicas {sorted(set(dead) & set(survivors))} "
                         f"listed both dead and surviving")
    stranded = int(state.stranded.sum().item())
    recovery_io = {
        "dead_replicas": dead,
        "survivors": sorted(survivors),
        "promoted": min(survivors),
        # one lock-entry READ per slot on the promoted replica (the
        # mid-fan-out certification sweep) ...
        "promote_reads": cfg.n_slots,
        "promote_bytes": cfg.n_slots * cfg.lock_bytes,
        # ... plus one break CAS re-arming each CN-stranded lock on every
        # surviving replica's copy of the word
        "repair_rearm_cas": stranded * len(survivors),
    }
    return state, recovery_io


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _partition(state: StoreState, s: int, per: int, hper: int) -> StoreState:
    """Shard ``s``'s partition as a shard-local state (views, no copy)."""
    sl = slice(s * per, (s + 1) * per)
    return StoreState(ptr=state.ptr[sl], meta=state.meta[sl],
                      epoch=state.epoch[sl],
                      heap=state.heap[s * hper:(s + 1) * hper],
                      heap_top=state.heap_top[s])


def _assemble(state: StoreState, parts: dict[int, StoreState], n: int,
              per: int, hper: int) -> StoreState:
    """The global-layout state holding ``parts`` (shard -> partition); the
    partitions not in ``parts`` are ``state``'s."""
    if len(parts) == n:
        order = [parts[s] for s in range(n)]
        return StoreState(
            *(torch.cat([getattr(p, f) for p in order])
              for f in ("ptr", "meta", "epoch", "heap")),
            heap_top=torch.stack([p.heap_top for p in order]))
    out = StoreState(*(getattr(state, f.name).clone()
                       for f in dataclasses.fields(StoreState)))
    for s, p in parts.items():
        sl = slice(s * per, (s + 1) * per)
        out.ptr[sl], out.meta[sl], out.epoch[sl] = p.ptr, p.meta, p.epoch
        out.heap[s * hper:(s + 1) * hper] = p.heap
        out.heap_top[s] = p.heap_top
    return out


def _psum_results(mesh, parts: list[Results]) -> Results:
    """Reassemble exact per-op results across shards: non-owning shards emit
    each field's neutral element, so one sum per field (offset for the
    non-zero defaults) recovers the single-device values.  Elementwise, so
    it works unchanged on window-stacked ``(W, B)`` results."""
    tot = mesh.psum([Results(
        ok=r.ok.to(_I32), value=r.value - _NONE,
        pessimistic=r.pessimistic.to(_I32), combined=r.combined.to(_I32),
        wc_batch=r.wc_batch - 1, retries=r.retries, rank=r.rank,
        orphan_wait=r.orphan_wait,
        # each shard counts the rows of its own sub-run of a cross-shard
        # SCAN (the run split at partition edges)
        rows=r.rows) for r in parts])
    return dataclasses.replace(
        tot, ok=tot.ok > 0, value=tot.value + _NONE,
        pessimistic=tot.pessimistic > 0, combined=tot.combined > 0,
        wc_batch=tot.wc_batch + 1)


def _stack(items: list):
    cls = type(items[0])
    return cls(*(torch.stack([getattr(x, f.name) for x in items])
                 for f in dataclasses.fields(cls)))


def _window(stream: WindowStream, w: int) -> OpBatch:
    return OpBatch(*(getattr(stream.batch, f.name)[w]
                     for f in dataclasses.fields(OpBatch)))


def _check_layout(state: StoreState, n_shards: int) -> None:
    if tuple(state.heap_top.shape) != (n_shards,):
        raise ValueError(
            f"state.heap_top is {tuple(state.heap_top.shape)}, expected "
            f"({n_shards},): build the store with sharded_store_init for a "
            f"{n_shards}-way mesh")


def _run_shards(cfg: EngineConfig, mesh, state: StoreState,
                credits: CreditState, stream: WindowStream, prev_alive,
                per_alive: bool, traced: bool):
    """Every window on every local shard; the per-shard partials, unsummed:
    ``(parts, credits by shard, results by shard, io by shard, mass)``."""
    n = mesh.n_shards
    per, hper = shard_extents(cfg, n)
    _check_layout(state, n)
    lcfg = dataclasses.replace(cfg, n_slots=per, heap_slots=hper)
    parts = {s: _partition(state, s, per, hper) for s in mesh.shards}
    crs = {s: credits for s in mesh.shards}
    ress = {s: [] for s in mesh.shards}
    ios = {s: [] for s in mesh.shards}
    mass = []
    if per_alive:
        prev = stream.alive[0] if prev_alive is None else _as_bool(
            prev_alive, stream.alive.device)
    for w in range(stream.shape[0]):
        batch = _window(stream, w)
        live = {}
        if per_alive:
            alive = stream.alive[w]
            live = dict(alive=alive, died=prev & ~alive)
            prev = alive
        for s in mesh.shards:
            base = s * per
            owned = (batch.keys >= base) & (batch.keys < base + per)
            parts[s], crs[s], res, io = engine.apply_batch(
                lcfg, parts[s], crs[s], batch, valid=stream.valid[w],
                owned=owned, slot_base=base, **live)
            ress[s].append(res)
            ios[s].append(io)
        if traced:
            # the credit plane is replicated: any shard's table is the table
            mass.append(crs[mesh.shards[0]].credit.sum(dtype=_I32))
    return parts, crs, ress, ios, mass


def _finish(cfg, mesh, state, parts, crs, ress, ios, io_per_window: bool,
            per_shard_io: bool):
    """The run's outputs: the assembled store, the credit table, and the
    shards' stacked results and bills, each field summed over shards once."""
    n = mesh.n_shards
    per, hper = shard_extents(cfg, n)
    res_parts, io_parts = [], []
    for s in mesh.shards:
        res = _stack(ress[s])
        io = _stack(ios[s])
        if not io_per_window:
            io = IOMetrics(*(getattr(io, f.name).sum(0, dtype=_I32)
                             for f in dataclasses.fields(IOMetrics)))
        if per_shard_io:
            # shard s's bill in its own slot of a trailing (n_shards,) axis:
            # the one sum per field assembles the per-shard plane, and
            # summing that plane gives the global bill
            onehot = (torch.arange(n, device=mesh.device) == s).to(_I32)
            io = IOMetrics(*(getattr(io, f.name)[..., None] * onehot
                             for f in dataclasses.fields(IOMetrics)))
        res_parts.append(res)
        io_parts.append(io)
    return (_assemble(state, parts, n, per, hper), crs[mesh.shards[0]],
            _psum_results(mesh, res_parts), mesh.psum(io_parts))


def apply_batch_sharded(cfg: EngineConfig, mesh, state: StoreState,
                        credits: CreditState, batch: OpBatch, valid=None
                        ) -> tuple[StoreState, CreditState, Results,
                                   IOMetrics]:
    """``engine.apply_batch`` over the shards of ``mesh``: the same
    signature modulo the mesh; ``state`` comes from ``sharded_store_init``
    / ``sharded_populate``."""
    if valid is None:
        valid = batch.kinds != OpKind.NOP
    # a one-window stream with no liveness plane: the engine groups local
    # write combining by sort, as the reference's apply_batch_sharded does
    stream = WindowStream(
        batch=OpBatch(*(getattr(batch, f.name)[None]
                        for f in dataclasses.fields(OpBatch))),
        valid=valid[None],
        alive=torch.ones((1, 1), dtype=torch.bool, device=valid.device))
    parts, crs, ress, ios, _ = _run_shards(cfg, mesh, state, credits, stream,
                                           None, False, False)
    st, cr, res, io = _finish(cfg, mesh, state, parts, crs, ress, ios, False,
                              False)
    return st, cr, Results(*(getattr(res, f.name)[0]
                             for f in dataclasses.fields(Results))), io


def run_windows_sharded(cfg: EngineConfig, mesh, state: StoreState,
                        credits: CreditState, stream: WindowStream, *,
                        io_per_window: bool = False,
                        per_shard_io: bool = False, prev_alive=None
                        ) -> tuple[StoreState, CreditState, Results,
                                   IOMetrics]:
    """Sharded ``runner.run_windows``: every window of ``stream`` on every
    shard, each re-deriving its ``owned`` mask from that window's keys and
    running the full-window credit plane, so per-window ``Results``, bills
    (``io_per_window=True``), the credit table and the store view equal the
    single-device ``run_windows``.  ``prev_alive`` overrides the liveness
    row assumed before window 0, so a run split around a shard failover
    still strands crashes at the boundary.

    ``per_shard_io=True`` appends a trailing ``(n_shards,)`` axis to every
    ``IOMetrics`` field: shard ``s``'s slice is the bill its own partition
    served, and the sum over shards is the global bill.
    """
    parts, crs, ress, ios, _ = _run_shards(cfg, mesh, state, credits, stream,
                                           prev_alive, True, False)
    return _finish(cfg, mesh, state, parts, crs, ress, ios, io_per_window,
                   per_shard_io)


def run_windows_sharded_traced(cfg: EngineConfig, mesh, state: StoreState,
                               credits: CreditState, stream: WindowStream, *,
                               prev_alive=None):
    """Sharded ``runner.run_windows_traced``: ``(state, credits, results,
    io_per_window, credit_mass)``, the ``(W,)`` credit-table mass taken from
    the replicated credit plane."""
    parts, crs, ress, ios, mass = _run_shards(cfg, mesh, state, credits,
                                              stream, prev_alive, True, True)
    return _finish(cfg, mesh, state, parts, crs, ress, ios, True,
                   False) + (torch.stack(mass),)

