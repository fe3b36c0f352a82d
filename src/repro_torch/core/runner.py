"""Multi-window execution and the modeled metrics (port of
``repro.core.runner``).

``run_windows`` executes every window of a stacked ``WindowStream`` in a
Python loop over ``engine.apply_batch`` — the reference's ``lax.scan`` — with
the same per-window semantics: window ``w``'s ``Results`` row, bill and
credit-table transition are those of the w-th ``apply_batch`` call.

Two throughput metrics:

* **device wall-clock** — host time around the window loop, ended by a
  device synchronize (the caller measures it);
* **MN-IOPS-modeled** — the paper's metric (§2.3, §5): ``modeled_throughput``
  converts the exact verb bill into ops/s under the ``SimParams`` cost
  model, and ``modeled_latency``/``latency_stats`` derive per-op modeled
  latency percentiles from each op's verb chain, wait-queue rank and MN NIC
  queueing.  These two are host numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.credits import CreditState
from repro_torch.core.engine import Results, StoreState
from repro_torch.core.simnet import SimParams
from repro_torch.core.types import (EngineConfig, IOMetrics, LatencyStats,
                                    OpBatch, OpKind, SyncMode, as_device,
                                    as_i32, to_numpy)

__all__ = ["WindowStream", "make_stream", "run_windows", "run_windows_traced",
           "io_window", "modeled_throughput", "modeled_latency",
           "latency_stats"]

_I32 = torch.int32


@dataclasses.dataclass
class WindowStream:
    """W stacked synchronization windows: every ``OpBatch`` field and the
    validity mask carry a leading window axis ``(W, B)``; ``alive`` is the
    ``(W, n_cns)`` liveness plane (a CN whose bit drops between consecutive
    windows died at the later one)."""
    batch: OpBatch
    valid: torch.Tensor   # (W, B) bool
    alive: torch.Tensor   # (W, n_cns) bool

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.batch.kinds.shape)


def _as_bool(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.bool)
    return torch.as_tensor(np.asarray(x, bool), device=device)


def make_stream(kinds, keys, values, n_cns: int = 1,
                lanes_per_cn: int | None = None, valid=None, alive=None,
                cn=None, device: str | torch.device = "cuda") -> WindowStream:
    """Stack ``(W, B)`` op arrays into a ``WindowStream`` on ``device``.

    Window ``w`` is exactly ``OpBatch.make(kinds[w], keys[w], values[w],
    n_cns, lanes_per_cn)``; ``alive`` (``(W, n_cns)``, default all alive)
    attaches a liveness schedule and ``cn`` (``(W, B)``) overrides the
    round-robin lane -> CN map."""
    dev = as_device(device)
    kinds = as_i32(kinds, dev)
    keys = as_i32(keys, dev)
    values = as_i32(values, dev)
    w, b = kinds.shape
    pos = torch.arange(b, dtype=_I32, device=dev).expand(w, b).contiguous()
    if lanes_per_cn is None:
        lanes_per_cn = max(b // max(n_cns, 1), 1)
    if cn is None:
        cn = torch.div(pos, lanes_per_cn, rounding_mode="floor") % max(n_cns, 1)
    else:
        cn = as_i32(cn, dev)
        if tuple(cn.shape) != (w, b):
            raise ValueError(f"cn plane is {tuple(cn.shape)}, expected {(w, b)}")
    valid = kinds != OpKind.NOP if valid is None else _as_bool(valid, dev)
    if alive is None:
        alive = torch.ones((w, max(n_cns, 1)), dtype=torch.bool, device=dev)
    else:
        alive = _as_bool(alive, dev)
        if tuple(alive.shape) != (w, max(n_cns, 1)):
            raise ValueError(
                f"alive is {tuple(alive.shape)}, expected ({w}, "
                f"{max(n_cns, 1)}) — the liveness schedule must match the "
                f"stream's windows AND its CN count")
    batch = OpBatch(kinds=kinds, keys=keys, values=values, pos=pos, cn=cn)
    return WindowStream(batch=batch, valid=valid, alive=alive)


def _stack(items: list) -> Any:
    """Stack a list of equal dataclasses of tensors along a new axis 0."""
    cls = type(items[0])
    return cls(*(torch.stack([getattr(x, f.name) for x in items])
                 for f in dataclasses.fields(cls)))


def _run(cfg: EngineConfig, state: StoreState, credits: CreditState,
         stream: WindowStream, prev_alive, io_per_window: bool,
         traced: bool):
    prev = stream.alive[0] if prev_alive is None else _as_bool(
        prev_alive, stream.alive.device)
    results, ios, mass = [], [], []
    for w in range(stream.shape[0]):
        batch = OpBatch(*(getattr(stream.batch, f.name)[w]
                          for f in dataclasses.fields(OpBatch)))
        alive = stream.alive[w]
        # CNs alive at window start but not through it died HERE
        died = prev & ~alive
        state, credits, res, io = engine.apply_batch(
            cfg, state, credits, batch, valid=stream.valid[w], alive=alive,
            died=died)
        results.append(res)
        ios.append(io)
        if traced:
            mass.append(credits.credit.sum(dtype=_I32))
        prev = alive
    res = _stack(results)
    io = _stack(ios)
    if not io_per_window:
        io = IOMetrics(*(getattr(io, f.name).sum(0, dtype=_I32)
                         for f in dataclasses.fields(IOMetrics)))
    if traced:
        return state, credits, res, io, torch.stack(mass)
    return state, credits, res, io


def run_windows(cfg: EngineConfig, state: StoreState, credits: CreditState,
                stream: WindowStream, io_per_window: bool = False,
                prev_alive=None):
    """Execute every window of ``stream``; returns ``(state, credits,
    results, io)`` with ``results`` stacked over the window axis and ``io``
    summed over windows (``io_per_window=True`` keeps ``(W,)`` leaves).
    ``prev_alive`` is the liveness row before the stream (default: its
    first row, so nothing dies at window 0)."""
    return _run(cfg, state, credits, stream, prev_alive, io_per_window, False)


def run_windows_traced(cfg: EngineConfig, state: StoreState,
                       credits: CreditState, stream: WindowStream,
                       prev_alive=None):
    """``run_windows`` with per-window bills and the credit-table mass after
    each window: ``(state, credits, results, io, credit_mass)``."""
    return _run(cfg, state, credits, stream, prev_alive, True, True)


def io_window(ios: IOMetrics, w: int) -> IOMetrics:
    """Window ``w``'s bill out of a stacked (``io_per_window=True``) bill."""
    return IOMetrics(*(getattr(ios, f.name)[w]
                       for f in dataclasses.fields(IOMetrics)))


def modeled_throughput(io: IOMetrics, p: SimParams, n_ops: int
                       ) -> dict[str, Any]:
    """MN-IOPS-bound throughput of ``n_ops`` ops with verb bill ``io``: the
    memory-pool NIC serves ``mn_cap`` verbs and ``mn_bw`` bytes per us."""
    mn_iops = int(io.mn_iops.item())
    mn_bytes = int(io.mn_bytes.item())
    iops_ticks = mn_iops / p.mn_cap
    bw_ticks = mn_bytes / p.mn_bw
    ticks = max(iops_ticks, bw_ticks)
    return {
        "modeled_ticks_us": round(ticks, 2),
        "modeled_mops": round(n_ops / ticks, 4) if ticks > 0 else float("inf"),
        "bound": "iops" if iops_ticks >= bw_ticks else "bandwidth",
        "mn_cap_per_us": p.mn_cap,
        "mn_bw_bytes_per_us": p.mn_bw,
    }


def modeled_latency(cfg: EngineConfig, kinds, res: Results, p: SimParams,
                    valid=None, scan_counts=None) -> np.ndarray:
    """Per-op modeled completion time in microseconds (host-side numpy):
    critical-path RTTs of each op's verb chain (queue waits enter through
    ``Results.rank``), plus MN NIC queueing behind the verbs of the ops
    before it in the window, plus lease waits on orphaned locks.  Works on
    ``(B,)`` or ``(W, B)`` results; invalid lanes are NaN."""
    kinds = to_numpy(kinds)
    ok = to_numpy(res.ok)
    pess = to_numpy(res.pessimistic)
    comb = to_numpy(res.combined)
    rank = to_numpy(res.rank).astype(np.float64)
    polls = to_numpy(res.retries).astype(np.float64)
    m = to_numpy(res.wc_batch).astype(np.float64)
    if valid is None:
        valid = kinds != OpKind.NOP
    else:
        valid = to_numpy(valid) & (kinds != OpKind.NOP)
    search = kinds == OpKind.SEARCH
    insert = kinds == OpKind.INSERT
    update = kinds == OpKind.UPDATE
    delete = kinds == OpKind.DELETE
    scan = kinds == OpKind.SCAN
    rows = to_numpy(res.rows).astype(np.float64)
    if scan_counts is None:
        counts = np.where(scan, rows, 0.0)
    else:
        # the model bills the leaves the engine traversed (clipped length)
        counts = np.where(scan, np.minimum(
            to_numpy(scan_counts).astype(np.float64), float(cfg.scan_max)), 0.0)
    idx = float(cfg.index_read_iops)
    rtt, cnr = float(p.rtt), float(p.cn_rtt)

    # ---- critical-path chain: sequential MN RTTs + CN-msg hops (us)
    chain = np.full(kinds.shape, idx, np.float64)
    extra = np.zeros(kinds.shape, np.float64)
    chain = np.where(search, idx + ok, chain)
    chain = np.where(insert, idx + 2.0, chain)
    opt_u = update & ~pess
    chain = np.where(opt_u & ~comb, idx + 2.0 + 2.0 * rank, chain)
    chain = np.where(opt_u & comb, idx + 2.0, chain)
    if cfg.mode == SyncMode.OSYNC:
        chain = np.where(delete, idx + 1.0 + 2.0 * rank, chain)
    else:
        chain = np.where(delete, idx + 3.0, chain)
    if cfg.mode == SyncMode.SPIN:
        chain = np.where(update & pess, idx + 4.0 + 3.0 * rank, chain)
    elif cfg.mode == SyncMode.MCS:
        chain = np.where(update & pess, idx + 4.0, chain)
        extra = np.where(update & pess, rank * (3.0 * rtt + cnr), extra)
    elif cfg.mode == SyncMode.CIDER:
        chain = np.where(update & pess, idx + 4.0 + (m > 1), chain)
        extra = np.where(update & pess & (m > 1), 2.0 * cnr, extra)

    # SCAN: leaf-run READ round + a value round when any row was found
    found = (rows > 0).astype(np.float64)
    if cfg.mode == SyncMode.OSYNC:
        chain = np.where(scan, idx + 2.0 + found, chain)
    elif cfg.mode == SyncMode.SPIN:
        chain = np.where(scan, idx + 2.0 + found + 3.0 * rank, chain)
    elif cfg.mode == SyncMode.MCS:
        chain = np.where(scan, idx + 2.0 + found, chain)
        extra = np.where(scan, rank * (3.0 * rtt + cnr), extra)
    else:
        chain = np.where(scan, idx + 1.0 + found
                         + np.where(rank > 0, 4.0, 0.0), chain)

    # ---- MN NIC queueing: wait behind earlier ops' verbs in the window
    verbs = np.full(kinds.shape, idx, np.float64)
    verbs = np.where(search, idx + ok, verbs)
    verbs = np.where(insert, idx + 2.0, verbs)
    verbs = np.where(opt_u & ~comb, idx + 2.0 + 2.0 * rank, verbs)
    if cfg.mode == SyncMode.OSYNC:
        verbs = np.where(delete, idx + 1.0 + 2.0 * rank, verbs)
    else:
        verbs = np.where(delete, idx + 3.0, verbs)
    if cfg.mode == SyncMode.SPIN:
        verbs = np.where(update & pess, idx + 4.0 + polls, verbs)
    elif cfg.mode == SyncMode.MCS:
        verbs = np.where(update & pess, idx + 4.0, verbs)
    elif cfg.mode == SyncMode.CIDER:
        verbs = np.where(update & pess & comb, idx + 2.0, verbs)
        verbs = np.where(update & pess & ~comb, idx + 4.0 + (m > 1), verbs)
    scan_base = idx + counts + rows
    if cfg.mode == SyncMode.OSYNC:
        verbs = np.where(scan, scan_base + counts, verbs)
    elif cfg.mode in (SyncMode.SPIN, SyncMode.MCS):
        verbs = np.where(scan, scan_base + 2.0 * counts, verbs)
    else:
        verbs = np.where(scan, scan_base + 2.0 * (rank > 0), verbs)
    # replication: the write portion of each op's footprint fans out xR
    rep = float(p.n_replicas)
    if rep > 1.0:
        ro = np.full(kinds.shape, idx, np.float64)
        ro = np.where(search, idx + ok, ro)
        ro = np.where(scan, scan_base, ro)
        if cfg.mode == SyncMode.OSYNC:
            ro = np.where(scan, scan_base + counts, ro)
        verbs = ro + rep * (verbs - ro)
        extra = np.where(insert | update | delete,
                         extra + float(p.replica_rtt), extra)
    verbs = np.where(valid, verbs, 0.0)
    backlog = np.cumsum(verbs, axis=-1) - verbs
    # orphaned-lock lease waits: lease expiry + stale-epoch READ + break CAS
    orphan = to_numpy(res.orphan_wait).astype(np.float64)
    lat = (rtt * chain + extra + backlog / float(p.mn_cap)
           + orphan * (float(p.lease_us) + 2.0 * rtt))
    return np.where(valid, lat, np.nan)


def latency_stats(lat_us: np.ndarray) -> LatencyStats:
    """Reduce ``modeled_latency`` output to the paper's percentiles."""
    lat = np.asarray(lat_us, np.float64).ravel()
    lat = lat[~np.isnan(lat)]
    if lat.size == 0:
        return LatencyStats(0.0, 0.0, 0.0, 0.0, 0)
    return LatencyStats(
        p50_us=round(float(np.percentile(lat, 50)), 2),
        p99_us=round(float(np.percentile(lat, 99)), 2),
        mean_us=round(float(lat.mean()), 2),
        max_us=round(float(lat.max()), 2),
        n_ops=int(lat.size))
