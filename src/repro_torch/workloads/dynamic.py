"""Dynamic-contention workload generators (time-varying window streams; port
of ``repro.workloads.dynamic``: identical arrays from identical seeds).

CIDER's headline mechanism — the contention-aware AIMD credit scheme (§4.3,
Algorithm 1) — exists because hotness *changes over time*, but a stationary
Zipf draw (``workloads.ycsb``) never exercises the adaptation path end
to end: credits must grow while a key is hot and drain (multiplicative
decrease) after the hotspot moves.  These generators produce ``(W, B)``
``OpBatchNp`` streams whose contention profile is a function of the window
index — drop-in inputs for ``repro_torch.core.runner.make_stream`` /
``run_windows`` — modeled on the paper's dynamic/skew experiments
(Figs 13-15) and the client/skew sweep style of FUSEE and Outback.

Four scenario families (registry: ``SCENARIOS``):

* ``hotspot_shift`` — a compact hot set absorbs ``hot_frac`` of the traffic;
  at window ``shift_window`` it jumps to a disjoint key set, while exactly
  one UPDATE per *old* hot key per window keeps probing the abandoned set —
  so the AIMD drain (WC batch == 1 -> ``credit //= aimd_factor``) is
  observable as a trajectory instead of leaving stale credits frozen.
* ``flash_crowd`` — the hot fraction ramps 0 -> ``peak_frac`` -> 0 as a
  triangle (a flash crowd arriving and dispersing).
* ``churn`` — alternating INSERT / DELETE phases over an initially EMPTY
  key region, on top of a stationary skewed UPDATE/SEARCH mix on the
  populated region (scenarios carry ``populated_frac`` < 1).
* ``skew_drift`` — Zipf theta interpolates linearly ``theta0 -> theta1``
  across windows (Fig 13's skew sweep as one non-stationary stream).

DESIGN.md §7.1 (scenario generators): time-varying contention streams that
exercise the AIMD adaptation end to end.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.types import OpKind
from repro_torch.workloads.ycsb import OpBatchNp, WorkloadSpec, generate_ops
from repro_torch.workloads.zipf import ZipfSampler

__all__ = ["Scenario", "SCENARIOS", "hotspot_shift", "flash_crowd", "churn",
           "skew_drift"]


def _finish(kinds: np.ndarray, keys: np.ndarray, n_clients: int,
            rng: np.random.Generator) -> OpBatchNp:
    w, b = kinds.shape
    values = rng.integers(1, 2**31 - 1, size=(w, b), dtype=np.int64)
    clients = np.broadcast_to((np.arange(b) % n_clients).astype(np.int32),
                              (w, b)).copy()
    return OpBatchNp(kinds=kinds.astype(np.uint8), keys=keys.astype(np.int64),
                     values=values, clients=clients)


def hotspot_shift(windows: int, n_ops: int, n_keys: int, n_clients: int,
                  seed: int = 0, *, write_ratio: float = 0.5,
                  theta: float = 0.99, hot_keys: int = 8,
                  hot_frac: float = 0.5, shift_window: int | None = None,
                  return_sets: bool = False):
    """Hot set A for windows [0, shift), disjoint hot set B afterwards.

    Post-shift, every old hot key still receives exactly ONE update per
    window (a drain probe): with leftover credit the probe takes the
    pessimistic path alone (WC batch 1), which is precisely the AIMD
    multiplicative-decrease branch.  ``return_sets=True`` additionally
    returns ``(set_a, set_b)`` so tests can track per-key credit drain.
    """
    if shift_window is None:
        shift_window = windows // 2
    if n_ops < hot_keys:
        raise ValueError(f"n_ops ({n_ops}) must be >= hot_keys ({hot_keys}) "
                         f"to place one drain probe per old hot key")
    rng = np.random.default_rng(seed + 17)
    zipf = ZipfSampler(n_keys, theta, seed=seed)
    keys = zipf.sample(windows * n_ops).reshape(windows, n_ops)
    perm = rng.permutation(n_keys)[: 2 * hot_keys]
    set_a, set_b = perm[:hot_keys], perm[hot_keys:]
    kinds = np.where(rng.random((windows, n_ops)) < write_ratio,
                     OpKind.UPDATE, OpKind.SEARCH).astype(np.uint8)
    for w in range(windows):
        hot = rng.random(n_ops) < hot_frac
        cur = set_a if w < shift_window else set_b
        keys[w, hot] = rng.choice(cur, size=int(hot.sum()))
        if w >= shift_window:
            # drain probes: one UPDATE per old hot key, distinct lanes
            # (cold lanes preferred; at high hot_frac fall back to any lane)
            pool = np.flatnonzero(~hot)
            if pool.size < hot_keys:
                pool = np.arange(n_ops)
            lanes = rng.choice(pool, size=hot_keys, replace=False)
            keys[w, lanes] = set_a
            kinds[w, lanes] = OpKind.UPDATE
    ops = _finish(kinds, keys, n_clients, rng)
    return (ops, (set_a, set_b)) if return_sets else ops


def flash_crowd(windows: int, n_ops: int, n_keys: int, n_clients: int,
                seed: int = 0, *, write_ratio: float = 0.5,
                theta: float = 0.99, hot_keys: int = 8,
                peak_frac: float = 0.8, peak_window: int | None = None,
                ) -> OpBatchNp:
    """Triangular ramp: the hot fraction climbs linearly from 0 at window 0
    to ``peak_frac`` at ``peak_window`` and back down to 0 at the end."""
    if peak_window is None:
        peak_window = windows // 2
    rng = np.random.default_rng(seed + 29)
    zipf = ZipfSampler(n_keys, theta, seed=seed)
    keys = zipf.sample(windows * n_ops).reshape(windows, n_ops)
    hot_set = rng.permutation(n_keys)[:hot_keys]
    kinds = np.where(rng.random((windows, n_ops)) < write_ratio,
                     OpKind.UPDATE, OpKind.SEARCH).astype(np.uint8)
    last = windows - 1
    for w in range(windows):
        if w == peak_window:            # the apex is always the full crowd,
            ramp = 1.0                  # even when it sits on an endpoint
        elif w < peak_window:
            ramp = w / peak_window
        else:
            ramp = (last - w) / (last - peak_window)
        hot = rng.random(n_ops) < peak_frac * ramp
        keys[w, hot] = rng.choice(hot_set, size=int(hot.sum()))
    return _finish(kinds, keys, n_clients, rng)


def churn(windows: int, n_ops: int, n_keys: int, n_clients: int,
          seed: int = 0, *, write_ratio: float = 0.5, theta: float = 0.99,
          churn_frac: float = 0.15, phase_len: int | None = None,
          populated_frac: float = 0.5) -> OpBatchNp:
    """INSERT/DELETE phases over the initially-empty region
    ``[populated_frac * n_keys, n_keys)``: phases of ``phase_len`` windows
    alternate between inserting fresh keys there and deleting them, on top
    of a stationary skewed UPDATE/SEARCH mix on the populated region."""
    if phase_len is None:
        phase_len = max(windows // 8, 1)
    rng = np.random.default_rng(seed + 43)
    n_pop = int(populated_frac * n_keys)
    zipf = ZipfSampler(n_pop, theta, seed=seed)
    keys = zipf.sample(windows * n_ops).reshape(windows, n_ops)
    kinds = np.where(rng.random((windows, n_ops)) < write_ratio,
                     OpKind.UPDATE, OpKind.SEARCH).astype(np.uint8)
    for w in range(windows):
        cm = rng.random(n_ops) < churn_frac
        keys[w, cm] = rng.integers(n_pop, n_keys, size=int(cm.sum()))
        kind = (OpKind.INSERT if (w // phase_len) % 2 == 0 else OpKind.DELETE)
        kinds[w, cm] = kind
    return _finish(kinds, keys, n_clients, rng)


def skew_drift(windows: int, n_ops: int, n_keys: int, n_clients: int,
               seed: int = 0, *, write_ratio: float = 0.5,
               theta0: float = 0.4, theta1: float = 1.2) -> OpBatchNp:
    """theta(w) interpolates linearly from ``theta0`` to ``theta1``: the
    stream starts near-uniform (optimistic-friendly) and ends heavily skewed
    (combining-friendly), forcing the credit scheme to follow the drift."""
    spec = WorkloadSpec("skew-drift", write_ratio, 1.0 - write_ratio)
    wins = []
    for w in range(windows):
        th = theta0 + (theta1 - theta0) * w / max(windows - 1, 1)
        if abs(th - 1.0) < 1e-6:          # ZipfSampler excludes theta == 1
            th += 1e-4
        wins.append(generate_ops(spec, n_ops, n_keys, n_clients,
                                 seed=seed + w, theta=th))
    return OpBatchNp(kinds=np.stack([o.kinds for o in wins]),
                     keys=np.stack([o.keys for o in wins]),
                     values=np.stack([o.values for o in wins]),
                     clients=np.stack([o.clients for o in wins]))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A registered dynamic-contention scenario.

    ``generate`` has the uniform signature
    ``(windows, n_ops, n_keys, n_clients, seed=0, **overrides)``;
    ``populated_frac`` tells harnesses how much of ``[0, n_keys)`` to
    pre-populate (churn needs empty headroom for its INSERT phases).
    """
    name: str
    generate: Callable[..., OpBatchNp]
    populated_frac: float = 1.0
    description: str = ""

    def populate_keys(self, n_keys: int) -> np.ndarray:
        return np.arange(int(self.populated_frac * n_keys))


SCENARIOS = {
    "hotspot_shift": Scenario(
        "hotspot_shift", hotspot_shift,
        description="hot set jumps to disjoint keys at the mid window; "
                    "drain probes keep the old set observable"),
    "flash_crowd": Scenario(
        "flash_crowd", flash_crowd,
        description="hot fraction ramps 0 -> peak -> 0 triangularly"),
    "churn": Scenario(
        "churn", churn, populated_frac=0.5,
        description="alternating INSERT/DELETE phases over an empty region "
                    "plus a stationary skewed update mix"),
    "skew_drift": Scenario(
        "skew_drift", skew_drift,
        description="Zipf theta drifts linearly theta0 -> theta1"),
}
