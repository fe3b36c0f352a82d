"""Watch CIDER adapt on the port: a hotspot shift, window by window.

The counterpart of ``examples/dynamic_contention.py`` on ``repro_torch``: a
dynamic-contention stream whose hot set jumps to disjoint keys mid-run
(``workloads.dynamic.hotspot_shift``), every window through
``runner.run_windows_traced``, and the per-window trajectory: the
pessimistic ratio climbing while the hotspot is hot, collapsing when it
moves, recovering as the AIMD credits re-warm, with the modeled p99 flat
thanks to global write combining.  ``wc_combine`` runs every window on a
card; ``--device cpu`` runs its plain version.

    PYTHONPATH=src python examples_torch/dynamic_contention.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import runner
from repro_torch.core.credits import credit_init
from repro_torch.core.engine import populate, store_init
from repro_torch.core.simnet import SimParams
from repro_torch.core.types import (EngineConfig, OpKind, SyncMode, as_device,
                                    to_numpy)
from repro_torch.workloads.dynamic import hotspot_shift

W, B, N_KEYS, N_CNS, SHIFT = 16, 512, 1024, 64, 8


def main(argv=None) -> list[dict]:
    """Print the trajectory; returns a row a window: updates, pessimistic
    and combined updates, credit mass and the modeled p99 (us)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the kernels) or cpu (plain versions)")
    dev = as_device(ap.parse_args(argv).device)

    ops = hotspot_shift(W, B, N_KEYS, n_clients=N_CNS, seed=3,
                        shift_window=SHIFT)
    stream = runner.make_stream(ops.kinds, ops.keys, ops.values, n_cns=N_CNS,
                                device=dev)
    cfg = EngineConfig(n_slots=N_KEYS, heap_slots=N_KEYS + W * B,
                       mode=SyncMode.CIDER)
    keys0 = np.arange(N_KEYS)
    store = populate(cfg, store_init(cfg, dev), keys0, keys0)
    store, credits, res, ios, mass = runner.run_windows_traced(
        cfg, store, credit_init(4096, dev), stream)

    lat = runner.modeled_latency(cfg, ops.kinds, res, SimParams())
    upd = ops.kinds == OpKind.UPDATE
    pess = to_numpy(res.pessimistic)
    comb = to_numpy(res.combined)
    mass = to_numpy(mass)

    print(f"{'win':>4s} {'pess%':>6s} {'wc%':>6s} {'credits':>8s} "
          f"{'p99 us':>7s}  (hotspot shifts at window {SHIFT})")
    rows = []
    for w in range(W):
        row = {"window": w, "updates": int(upd[w].sum()),
               "pess": int((pess[w] & upd[w]).sum()),
               "wc": int(comb[w].sum()), "credits": int(mass[w]),
               "p99_us": float(np.nanpercentile(lat[w], 99))}
        rows.append(row)
        nw = max(row["updates"], 1)
        marker = " <-- shift" if w == SHIFT else ""
        print(f"{w:4d} {100 * row['pess'] / nw:6.1f} "
              f"{100 * row['wc'] / nw:6.1f} {row['credits']:8d} "
              f"{row['p99_us']:7.1f}{marker}")
    return rows


if __name__ == "__main__":
    main()
