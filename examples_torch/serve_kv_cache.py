"""Serving example on the port: continuous batching with the CIDER-managed
prefix-cache page table; batched requests sharing a system prompt get
prefix hits.

The counterpart of ``examples/serve_kv_cache.py`` on ``repro_torch``: the
port's ``launch.serve.main`` at the reference example's arguments (the
smoke ``qwen3-0.6b``, 12 requests, 4 slots, a 16-token shared prefix).  On
a card the decode runs ``paged_attention`` and the page table's engine
``wc_combine``; ``--device cpu`` runs their plain versions.

    PYTHONPATH=src python examples_torch/serve_kv_cache.py [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core.types import as_device
from repro_torch.launch.serve import main as serve_main

ARGS = ["--arch", "qwen3-0.6b", "--smoke", "--requests", "12", "--slots", "4",
        "--max-new", "6", "--prompt-len", "32", "--shared-prefix", "16"]


def main(argv=None) -> dict:
    """Serve; returns the scheduler's stats."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    as_device(args.device)
    stats = serve_main(ARGS + ["--device", args.device])
    assert stats["completed"] == 12
    assert stats["prefix_hits"] > 0, "expected shared-prefix cache hits"
    print("serving example OK")
    return stats


if __name__ == "__main__":
    main()
