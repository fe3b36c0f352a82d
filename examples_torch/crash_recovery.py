"""Watch a crash storm strand locks on the port, and the repair asymmetry
that breaks them (DESIGN.md §4.6).

The counterpart of ``examples/crash_recovery.py`` on ``repro_torch``: a
quarter of the compute nodes fail-stop mid-run (``workloads.recovery.
crash_storm``); their queued pessimistic writes strand orphaned locks,
which the next surviving waiter breaks with a repair CAS after the lease
expires.  Per window and per mode it prints the repair-verb bill and the
modeled p99 (CIDER strands one lock per queue, MCS the whole chain of dead
nodes, SPIN survivors poll the MN for the entire lease), then runs a
2-shard failover of the same storm (``recovery.run_recovery_sharded``)
and asserts its bill bit-equal to the single-device run.  Both shards live
on the one device (``launch.mesh.make_local_mesh``), so no device count is
pinned.  ``wc_combine`` runs every window on a card; ``--device cpu`` runs
its plain version.

    PYTHONPATH=src python examples_torch/crash_recovery.py [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.core import runner
from repro_torch.core.credits import credit_init
from repro_torch.core.engine import populate, store_init
from repro_torch.core.simnet import SimParams
from repro_torch.core.types import (EngineConfig, IOMetrics, SyncMode,
                                    as_device, to_numpy)
from repro_torch.dist import store as dstore
from repro_torch.recovery import (FailoverEvent, run_recovery,
                                  run_recovery_sharded, time_to_repair)
from repro_torch.workloads.recovery import crash_storm

W, B, N_KEYS, N_CNS, CRASH = 16, 512, 1024, 64, 8
MODES = (SyncMode.SPIN, SyncMode.MCS, SyncMode.CIDER)


def main(argv=None) -> dict:
    """Print the tables; returns ``{"windows": [{mode: (repair_cas,
    p99_us)} a window], "summary": {mode: {"repair_cas",
    "windows_to_repair", "p99_us"}}, "failover": {"dead_shards",
    "reown_reads"}}`` (the p99s unrounded)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the kernels) or cpu (plain versions)")
    dev = as_device(ap.parse_args(argv).device)

    ops, sched = crash_storm(W, B, N_KEYS, n_clients=N_CNS, n_cns=N_CNS,
                             seed=3, crash_window=CRASH)
    keys0 = np.arange(N_KEYS)
    p = SimParams()
    print(f"{N_CNS - int(sched.n_alive()[-1])}/{N_CNS} CNs die at window "
          f"{CRASH} (lease {p.lease_us} us)\n")

    def stream():
        return runner.make_stream(ops.kinds, ops.keys, ops.values,
                                  n_cns=N_CNS, alive=sched.alive, device=dev)

    runs = {}
    for mode in MODES:
        cfg = EngineConfig(n_slots=N_KEYS, heap_slots=N_KEYS + W * B,
                           mode=mode)
        store = populate(cfg, store_init(cfg, dev), keys0, keys0)
        run = run_recovery(cfg, store, credit_init(4096, dev), stream())
        lat = runner.modeled_latency(cfg, ops.kinds, run.results, p,
                                     valid=run.valid)
        runs[mode] = (cfg, run, lat)

    print(f"{'win':>4s} " + "".join(f"{m.name + ' rep/p99':>18s}"
                                    for m in runs) + "   (crash at window "
          f"{CRASH})")
    out = {"windows": [], "summary": {}}
    for w in range(W):
        cells = {}
        row = f"{w:4d} "
        for mode, (cfg, run, lat) in runs.items():
            rep = int(to_numpy(run.io.repair_cas)[w])
            p99 = float(np.nanpercentile(lat[w], 99))
            cells[mode.name] = (rep, p99)
            row += f"{rep:8d} {p99:8.0f} "
        out["windows"].append(cells)
        print(row + (" <-- crash" if w == CRASH else ""))

    print("\nmode     repair_cas  windows_to_repair  post-crash p99 (us)")
    for mode, (cfg, run, lat) in runs.items():
        t = time_to_repair(run.io, CRASH)
        p99 = float(np.nanpercentile(lat[CRASH:], 99))
        out["summary"][mode.name] = {
            "repair_cas": int(t["repair_cas"]),
            "windows_to_repair": int(t["windows_to_repair"]), "p99_us": p99}
        print(f"{mode.name:8s} {t['repair_cas']:10d} "
              f"{t['windows_to_repair']:18d} {p99:10.0f}")

    # the same storm with a shard failover: the re-own is data-plane free
    cfg, single, _ = runs[SyncMode.CIDER]
    sst = dstore.sharded_populate(cfg, 2, dstore.sharded_store_init(
        cfg, 2, dev), keys0, keys0)
    sharded = run_recovery_sharded(cfg, 2, sst, credit_init(4096, dev),
                                   stream(),
                                   failovers=[FailoverEvent(CRASH, (0,))])
    for f in dataclasses.fields(IOMetrics):
        assert np.array_equal(to_numpy(getattr(single.io, f.name)),
                              to_numpy(getattr(sharded.io, f.name))), f.name
    rio = sharded.recovery_io[0]
    out["failover"] = {"dead_shards": list(rio["dead_shards"]),
                       "reown_reads": int(rio["reown_reads"])}
    print(f"\nshard failover at window {CRASH}: shard {rio['dead_shards']} "
          f"died, survivor re-owned its partition with {rio['reown_reads']} "
          f"replica reads — data-plane bill bit-equal to the single-device "
          f"run.")
    return out


if __name__ == "__main__":
    main()
