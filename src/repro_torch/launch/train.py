"""End-to-end training driver (port of ``repro.launch.train``): any
``--arch``, its smoke config with ``--smoke``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 50 --batch 8 --seq 64 --device cpu

Without ``--device`` it runs on the GPU (and raises when there is none).
The reference's loop: the deterministic resumable data pipeline, AdamW,
asynchronous checkpoints with restore on restart, the fleet heartbeat
monitor and, with ``--int8-grads``, int8 gradient compression with error
feedback.  A step is the forward and backward of ``Model.loss_fn`` (each
block checkpointed under ``remat="block"``; attention's backward the
hand-written kernel on a card) and ``adamw_update``; the only host sync is
the logged ``float(loss)`` (and ``gnorm`` on a logging step).  ``main``
returns the losses.
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.ckpt.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_config
from repro_torch.core.types import as_device
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.dist.compress import (ef_compress_tree, ef_decompress_tree,
                                       zeros_residuals)
from repro_torch.ft.failures import FleetMonitor
from repro_torch.models.model import Model
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         tree_leaves, tree_map)

__all__ = ["main", "train_step"]


def train_step(model: Model, params: dict, opt, batch: dict, residuals,
               lr: float, int8_grads: bool):
    """One step: ``(params, opt, loss, gnorm, residuals)``, loss and gnorm
    as device scalars."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = model.loss_fn(params, batch)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    it = iter(grads)
    grads = tree_map(lambda _: next(it), params)
    with torch.no_grad():
        if int8_grads:
            # what crosses the node boundary is int8 + one scale per leaf;
            # the rounding error is carried in ``residuals``
            q, scales, residuals = ef_compress_tree(grads, residuals)
            grads = tree_map(lambda g, d: d.to(g.dtype), grads,
                             ef_decompress_tree(q, scales))
        params = tree_map(lambda p: p.detach(), params)
        params, opt, gnorm = adamw_update(params, grads, opt, lr=lr)
    return params, opt, loss.detach(), gnorm, residuals


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt_every", type=int, default=50)
    ap.add_argument("--log_every", type=int, default=5)
    ap.add_argument("--int8-grads", action="store_true",
                    help="int8 + error-feedback gradient compression "
                         "(dist.compress) on the cross-node gradient path")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)

    dev = as_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(params)
    # error-feedback residuals are training state, checkpointed with the
    # rest; an empty tuple when compression is off
    residuals = zeros_residuals(params) if args.int8_grads else ()
    start_step = 0
    ckpt = AsyncCheckpointer(args.ckpt) if args.ckpt else None
    if ckpt and latest_step(args.ckpt) is not None:
        (params, opt, residuals), start_step = restore(
            args.ckpt, (params, opt, residuals))
        print(f"restored step {start_step} from {args.ckpt}")

    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                               global_batch=args.batch), device=dev)
    monitor = FleetMonitor(n_workers=1)

    losses = []
    for step in range(start_step, start_step + args.steps):
        t0 = time.time()
        batch = pipe.batch_at(step)
        params, opt, loss, gnorm, residuals = train_step(
            model, params, opt, batch, residuals, args.lr, args.int8_grads)
        loss = float(loss)
        losses.append(loss)
        monitor.beat(0, step_time_s=time.time() - t0)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} gnorm {float(gnorm):.3f} "
                  f"({time.time() - t0:.2f}s)", flush=True)
        if ckpt and step and step % args.ckpt_every == 0:
            ckpt.save_async(step, (params, opt, residuals))
    if ckpt:
        ckpt.save_async(start_step + args.steps, (params, opt, residuals))
        ckpt.wait()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    if not math.isfinite(losses[-1]):
        raise RuntimeError(f"final loss {losses[-1]} is not finite")
    return losses


if __name__ == "__main__":
    main()
