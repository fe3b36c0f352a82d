"""Reproduce the paper's headline micro-benchmark figure (Fig 11a) on the
port: pointer-array throughput against client count for all four schemes.

The counterpart of ``examples/cider_sim_figures.py`` on ``repro_torch``:
``core.sim.run_sim`` over ``CLIENTS`` x every ``SyncMode`` at
``SimParams(n_lanes=512, ticks=8192, max_ops=1024)`` on the write-intensive
workload over 1,000,000 keys.  On a card the ticks replay CUDA graphs and
``wc_combine`` runs inside every tick; ``--device cpu`` runs the ticks
eagerly with its plain version (minutes: the tests hold a table of 128
ticks to the reference's ``run_sim`` through ``sweep``).

    PYTHONPATH=src python examples_torch/cider_sim_figures.py [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.sim import SimParams, SimResult, make_streams, run_sim
from repro_torch.core.types import SyncMode, as_device
from repro_torch.workloads.ycsb import WORKLOADS

LANES, TICKS, MAX_OPS = 512, 8192, 1024
WORKLOAD, N_KEYS = "write-intensive", 1_000_000
CLIENTS = (16, 48, 128, 256, 512)


def params(lanes: int = LANES, ticks: int = TICKS) -> SimParams:
    return SimParams(n_lanes=lanes, ticks=ticks, max_ops=MAX_OPS)


def streams(p: SimParams, device) -> dict:
    return make_streams(p, WORKLOADS[WORKLOAD], n_keys=N_KEYS, device=device)


def sweep(p: SimParams, st: dict, clients=CLIENTS, modes=tuple(SyncMode),
          record: list | None = None) -> dict[int, dict[str, SimResult]]:
    """``run_sim`` of every client count x mode over one set of streams;
    ``{clients: {mode name: SimResult}}``.  ``record`` collects the runs'
    CUDA graphs (``run_sim``'s)."""
    return {nc: {m.name: run_sim(p, m, st, nc, record=record)
                 for m in modes} for nc in clients}


def csv_row(nc: int, row: dict[str, SimResult]) -> str:
    """The printed row of one client count."""
    return ",".join([str(nc)] + [f"{r.throughput_mops:.2f}"
                                 for r in row.values()])


def main(argv=None) -> dict[int, dict[str, SimResult]]:
    """Print the CSV table; returns ``sweep``'s results."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; graphed ticks, the kernel) or cpu")
    dev = as_device(ap.parse_args(argv).device)

    p = params()
    st = streams(p, dev)
    print("clients," + ",".join(m.name for m in SyncMode))
    t0 = time.perf_counter()
    out = {}
    for nc in CLIENTS:
        out.update(sweep(p, st, clients=(nc,)))
        print(csv_row(nc, out[nc]), flush=True)
    print(f"# {len(out) * len(SyncMode)} runs of {p.n_lanes} lanes x "
          f"{p.ticks} ticks on {dev} in {time.perf_counter() - t0:.2f} s")
    return out


if __name__ == "__main__":
    main()
