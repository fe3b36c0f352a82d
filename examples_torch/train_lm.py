"""End-to-end driver on the port: train a (reduced) model for a few hundred
steps and verify that the loss drops; exercises the data pipeline, AdamW,
checkpointing and restart.

The counterpart of ``examples/train_lm.py`` on ``repro_torch``: the port's
``launch.train.main`` for the smoke config, B 8 x S 64, a checkpoint every
100 steps.  ``main`` restores whatever checkpoint it finds in ``--ckpt``,
so the default is a directory of the port's own under the checkout's
``build/`` (``CKPT``, never the reference's ``/tmp/repro_ckpt``); pass a
fresh one for a run from step 0.
On a card attention runs ``flash_attention`` and its backward
``flash_attention_bwd``; ``--device cpu`` runs their plain versions.

    PYTHONPATH=src python examples_torch/train_lm.py [--arch qwen3-0.6b] \\
        [--steps 200] [--ckpt DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch.core.types import as_device
from repro_torch.launch.train import main as train_main

CKPT = str(Path(__file__).resolve().parents[1] / "build" / "train_lm_ckpt")


def main(argv=None) -> list[float]:
    """Train; returns the losses."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=CKPT,
                    help=f"checkpoint directory, restored from when it holds "
                         f"one (default {CKPT})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    as_device(args.device)

    losses = train_main(["--arch", args.arch, "--smoke",
                         "--steps", str(args.steps), "--batch", "8",
                         "--seq", "64", "--ckpt", args.ckpt,
                         "--ckpt_every", "100", "--device", args.device])
    assert losses[-1] < losses[0], "loss did not decrease"
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} "
          f"steps: OK")
    return losses


if __name__ == "__main__":
    main()
