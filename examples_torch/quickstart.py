"""Quickstart on the port: the paper's headline benchmark in one table.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``: the full
YCSB core suite (A-F, E's SCAN range reads over the radix leaf runs) under
each synchronization scheme, with the MN-IOPS-modeled throughput of each
cell.  The modeled Mops/s are pure functions of the verb bill, so they are
the reference's to the printed digit.  The engine's sorted-run sweeps run
the CUDA kernels on a card (``wc_combine`` every window, ``scan_probe`` on
E) and their plain versions with ``--device cpu``.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import runner
from repro_torch.core.credits import credit_init
from repro_torch.core.engine import populate, store_init
from repro_torch.core.simnet import SimParams
from repro_torch.core.types import EngineConfig, OpKind, SyncMode, as_device
from repro_torch.workloads.ycsb import YCSB, generate_ycsb_stream

W, B, N_KEYS, N_SLOTS, N_CNS, SCAN_MAX = 6, 512, 1024, 2048, 64, 16
MODES = [SyncMode.OSYNC, SyncMode.SPIN, SyncMode.MCS, SyncMode.CIDER]
LABELS = {"A": "A 50r/50u", "B": "B 95r/5u", "C": "C 100r",
          "D": "D 95r/5i latest", "E": "E 95scan/5i", "F": "F 50r/50rmw"}


def main(argv=None) -> list[dict]:
    """Print the table; returns a row a workload: its name, the number of
    ops and the modeled Mops/s of each mode in ``MODES`` order."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the kernels) or cpu (plain versions)")
    dev = as_device(ap.parse_args(argv).device)

    p = SimParams()
    print(f"modeled Mops/s (MN-NIC-bound)   "
          f"{'  '.join(f'{m.name:>7s}' for m in MODES)}")
    rows = []
    for name, spec in YCSB.items():
        ops = generate_ycsb_stream(spec, W, B, N_KEYS, n_clients=64, seed=7)
        stream = runner.make_stream(ops.kinds, ops.keys, ops.values,
                                    n_cns=N_CNS, device=dev)
        n_ops = int((ops.kinds != OpKind.NOP).sum())
        cells = []
        for mode in MODES:
            # the probe pass only for E (scan_max=0 is bit-identical when
            # the stream has no SCAN lanes)
            cfg = EngineConfig(n_slots=N_SLOTS, heap_slots=N_SLOTS + W * B,
                               mode=mode,
                               scan_max=SCAN_MAX if spec.scan > 0 else 0)
            store = populate(cfg, store_init(cfg, dev), np.arange(N_KEYS),
                             np.arange(N_KEYS))
            _, _, res, io = runner.run_windows(cfg, store,
                                               credit_init(1024, dev), stream)
            cells.append(runner.modeled_throughput(io, p, n_ops)
                         ["modeled_mops"])
        best = max(cells)
        row = "  ".join(f"{c:7.3f}" + ("*" if c == best else " ")
                        for c in cells)
        print(f"{LABELS[name]:30s}  {row}", flush=True)
        rows.append({"workload": name, "n_ops": n_ops, "mops": cells})
    print("\n(*) column winner; C and D bill identically in every mode by "
          "construction.\nFull-size committed matrix: BENCH_ycsb.json; field "
          "reference: docs/METRICS.md.")
    return rows


if __name__ == "__main__":
    main()
