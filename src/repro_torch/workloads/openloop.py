"""Open-loop arrival streams: Poisson / MMPP load binned into fixed windows
(port of ``repro.workloads.openloop``: identical arrays from identical seeds).

Layer: workloads (DESIGN.md §1, §12) — contract: host-side arrival-process
generators emitting *partially filled* ``(W, B)`` window planes plus an
explicit validity plane, drop-in inputs for ``repro_torch.core.runner.make_stream``.

Every other generator in this package is **closed-loop**: each window is a
full batch, so clients implicitly wait for the previous window to finish
before issuing — offered load always equals service capacity and queueing
collapse is invisible by construction.  FUSEE-style thin clients are
**open-loop**: requests arrive on their own clock regardless of service
progress, and the latency-vs-offered-load curve (the hockey stick) is what
exposes where a SyncMode's queues give out.  This module models that:

* each CN ``c`` receives ``Poisson(rho * lanes_per_cn)`` arrivals per window
  (``arrival="poisson"``), or a 2-state Markov-modulated Poisson process
  (``"mmpp"``: quiet/burst phases per CN with the burst rate scaled by
  ``burst_mult``, normalized so the *mean* rate still equals
  ``rho * lanes_per_cn`` — ``rho`` stays comparable across processes);
* arrivals queue FIFO per CN; each window issues at most ``lanes_per_cn``
  of them into the CN's lane block, recording per-op queueing delay in
  whole windows (``delay_windows``); excess backlog carries over;
* unfilled lanes are ``OpKind.NOP`` with ``valid=False`` — the window shape
  stays static for the window loop while occupancy varies, and the
  engine bills invalid lanes zero verbs.

The **dense re-pack contract** (DESIGN.md §12, tested not assumed): packing
each window's valid lanes to the front — preserving lane order and carrying
the explicit CN plane — must leave the bill, the store state, and the per-op
results bit-identical (results land at permuted lanes; ``repack.order``
maps them back).  Serialization sorts by (key, pos) and a stable pack
preserves relative pos order; local write-combining groups by (key, cn) and
the CN plane rides along — so nothing observable may move.

End-to-end open-loop latency = ``delay_windows * window_us`` (queueing in
whole windows) + the in-window modeled completion time from
``repro_torch.core.runner.modeled_latency``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import OpKind
from repro_torch.workloads.ycsb import WORKLOADS, WorkloadSpec, generate_ops

__all__ = ["OpenLoopSpec", "OpenLoopStream", "generate_openloop_stream",
           "dense_repack", "open_loop_latency"]


@dataclasses.dataclass(frozen=True)
class OpenLoopSpec:
    """One open-loop experiment cell.

    ``rho`` is offered load as a fraction of per-window service capacity:
    mean arrivals per CN per window = ``rho * lanes_per_cn``.  ``rho < 1``
    drains; ``rho >= 1`` grows backlog without bound — the regime the
    hockey-stick curve sweeps across.
    """

    n_cns: int = 4
    lanes_per_cn: int = 64
    windows: int = 32
    rho: float = 0.7
    n_keys: int = 4096
    mix: WorkloadSpec = WORKLOADS["write-intensive"]
    theta: float | None = None
    arrival: str = "poisson"        # "poisson" | "mmpp"
    burst_mult: float = 4.0         # MMPP burst-phase rate multiplier
    p_enter_burst: float = 0.10     # quiet -> burst, per window
    p_exit_burst: float = 0.30      # burst -> quiet, per window
    seed: int = 0

    def __post_init__(self):
        if self.arrival not in ("poisson", "mmpp"):
            raise ValueError(f"unknown arrival process {self.arrival!r}")
        if self.rho <= 0:
            raise ValueError("rho must be positive")


@dataclasses.dataclass
class OpenLoopStream:
    """Generated window planes (numpy, ``(W, B)`` with ``B = n_cns * L``).

    ``delay_windows[w, b]`` is how many whole windows the op at lane ``b``
    of window ``w`` sat in its CN's FIFO before being issued (0 = issued in
    its arrival window; 0 on invalid lanes).  ``arrivals``/``phases`` are
    the raw per-(window, CN) process draws kept for the statistical-law
    tests; ``backlog_end`` is what each CN still had queued at the horizon.
    """

    kinds: np.ndarray          # (W, B) uint8 OpKind, NOP on invalid lanes
    keys: np.ndarray           # (W, B) int64
    values: np.ndarray        # (W, B) int64
    cn: np.ndarray             # (W, B) int32 issuing CN (explicit plane)
    valid: np.ndarray          # (W, B) bool
    delay_windows: np.ndarray  # (W, B) int32
    arrivals: np.ndarray       # (W, n_cns) int64 raw arrival counts
    phases: np.ndarray         # (W, n_cns) int8 MMPP phase (0 quiet, 1 burst)
    backlog_end: np.ndarray    # (n_cns,) int64 unserved arrivals at horizon
    order: np.ndarray | None = None  # (W, B) repack permutation (see dense_repack)

    @property
    def offered(self) -> int:
        return int(self.arrivals.sum())

    @property
    def delivered(self) -> int:
        return int(self.valid.sum())


def _arrival_counts(spec: OpenLoopSpec, rng: np.random.Generator
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Draw the (W, n_cns) arrival-count and phase planes."""
    w, c = spec.windows, spec.n_cns
    base = spec.rho * spec.lanes_per_cn
    if spec.arrival == "poisson":
        phases = np.zeros((w, c), np.int8)
        counts = rng.poisson(base, size=(w, c))
        return counts.astype(np.int64), phases
    # MMPP: per-CN 2-state chain, started from the stationary distribution so
    # window 0 is not special; rates normalized to keep the mean at `base`.
    pe, px = spec.p_enter_burst, spec.p_exit_burst
    pi_burst = pe / (pe + px) if (pe + px) > 0 else 0.0
    mean_mult = (1.0 - pi_burst) + pi_burst * spec.burst_mult
    rates = np.array([base / mean_mult, base * spec.burst_mult / mean_mult])
    phases = np.zeros((w, c), np.int8)
    phase = (rng.random(c) < pi_burst).astype(np.int8)
    for t in range(w):
        phases[t] = phase
        u = rng.random(c)
        flip = np.where(phase == 0, u < pe, u < px)
        phase = np.where(flip, 1 - phase, phase).astype(np.int8)
    counts = rng.poisson(rates[phases])
    return counts.astype(np.int64), phases


def generate_openloop_stream(spec: OpenLoopSpec) -> OpenLoopStream:
    """Draw arrivals, run the per-CN FIFO queues, and bin into windows.

    Op *content* is drawn per CN at arrival time (one ``generate_ops`` call
    over the CN's total arrivals), so an op's identity does not depend on
    when the queue got around to issuing it — only its lane and its
    ``delay_windows`` do.
    """
    rng = np.random.default_rng(spec.seed)
    w, c, lanes = spec.windows, spec.n_cns, spec.lanes_per_cn
    b = c * lanes
    counts, phases = _arrival_counts(spec, rng)

    kinds = np.full((w, b), OpKind.NOP, np.uint8)
    keys = np.zeros((w, b), np.int64)
    values = np.zeros((w, b), np.int64)
    valid = np.zeros((w, b), bool)
    delay = np.zeros((w, b), np.int32)
    backlog_end = np.zeros(c, np.int64)

    for cn_id in range(c):
        total = int(counts[:, cn_id].sum())
        ops = generate_ops(spec.mix, max(total, 1), spec.n_keys, 1,
                           seed=spec.seed + 7919 * (cn_id + 1),
                           theta=spec.theta)
        # arrival window of each queued op, in FIFO order
        arrive_w = np.repeat(np.arange(w, dtype=np.int64), counts[:, cn_id])
        lo = cn_id * lanes
        issued = 0
        for t in range(w):
            avail = int(counts[: t + 1, cn_id].sum()) - issued
            n = min(avail, lanes)
            if n > 0:
                sl = slice(issued, issued + n)
                kinds[t, lo:lo + n] = ops.kinds[sl]
                keys[t, lo:lo + n] = ops.keys[sl]
                values[t, lo:lo + n] = ops.values[sl]
                valid[t, lo:lo + n] = True
                delay[t, lo:lo + n] = t - arrive_w[sl]
                issued += n
        backlog_end[cn_id] = total - issued

    cn_plane = np.broadcast_to(
        np.repeat(np.arange(c, dtype=np.int32), lanes), (w, b)).copy()
    return OpenLoopStream(kinds=kinds, keys=keys, values=values, cn=cn_plane,
                          valid=valid, delay_windows=delay, arrivals=counts,
                          phases=phases, backlog_end=backlog_end)


def dense_repack(ol: OpenLoopStream) -> OpenLoopStream:
    """Pack each window's valid lanes to the front (stable, order-preserving).

    Returns a same-shape stream whose ``order`` records the permutation:
    lane ``b`` of the repacked window ``w`` holds what lane
    ``order[w, b]`` of the original held, so per-op engine results can be
    mapped back with ``res[..., order]`` for the bit-equality check.  The
    explicit CN plane rides along, which is precisely why the (key, cn)
    write-combining groups — and hence the bill — cannot change.
    """
    # stable argsort of ~valid puts valid lanes first, original order kept
    order = np.argsort(~ol.valid, axis=1, kind="stable")
    take = np.take_along_axis
    return OpenLoopStream(
        kinds=take(ol.kinds, order, axis=1),
        keys=take(ol.keys, order, axis=1),
        values=take(ol.values, order, axis=1),
        cn=take(ol.cn, order, axis=1),
        valid=take(ol.valid, order, axis=1),
        delay_windows=take(ol.delay_windows, order, axis=1),
        arrivals=ol.arrivals, phases=ol.phases,
        backlog_end=ol.backlog_end, order=order)


def open_loop_latency(ol: OpenLoopStream, lat_us: np.ndarray,
                      window_us: float) -> np.ndarray:
    """End-to-end per-op latency: queueing delay + in-window completion.

    ``lat_us`` is ``runner.modeled_latency`` over the same stream
    (NaN on invalid lanes); ``window_us`` is the wall length of one
    synchronization window, which the scale benchmark sets to the modeled
    service time of a full window so queue delay and service time share a
    clock.  Invalid lanes come back NaN — feed the result straight to
    ``latency_stats``.
    """
    lat = np.asarray(lat_us, np.float64).reshape(ol.valid.shape)
    total = ol.delay_windows.astype(np.float64) * float(window_us) + lat
    return np.where(ol.valid, total, np.nan)
