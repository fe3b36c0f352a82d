"""Serving entry point: continuous batching + CIDER-managed prefix cache
(port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --smoke --requests 16 --max-new 8 --device cpu

Without ``--device`` it runs on the GPU (and raises when there is none).
``--arch`` takes any family with a decode step (all but the encoder,
``hubert-xlarge``, for which it raises ``ValueError`` as the reference's
``init_decode_state`` does); the vlm serves text only.  Weights are
random, from a seeded ``torch.Generator``.  Every token, prompt tokens
included, goes through ``Model.decode_step`` (the ``paged_attention``
kernel on a card for the attention layers; an MoE layer's dispatch runs
``wc_combine``); the prefix-cache page table runs on the CIDER engine (the
``wc_combine`` kernel on a card).  ``--layers`` cuts the model's depth
(the width stays the config's); the scheduler's stats depend on the
request stream alone, not on the model.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["main", "serve", "make_requests", "PAGE"]

PAGE = 16       # KV page size == prefix block size, tokens


def make_requests(vocab: int, n: int, prompt_len: int, shared_prefix: int,
                  max_new: int) -> list[Request]:
    """``n`` prompts that share their first ``shared_prefix`` tokens, drawn
    from ``np.random.default_rng(0)`` as the reference draws them."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, shared_prefix)
    reqs = []
    for rid in range(n):
        tail = rng.integers(0, vocab, prompt_len - shared_prefix)
        reqs.append(Request(rid=rid, tokens=np.concatenate([shared, tail]),
                            max_new=max_new))
    return reqs


def serve(model: Model, params, sched: Scheduler, smax: int
          ) -> dict[int, list[int]]:
    """Run the scheduler's queue to completion with greedy decoding; returns
    each request's generated tokens by request id."""
    dev = model.device
    states = {}
    outs = {}
    while sched.queue or sched.active():
        sched.step_admit()
        for slot, req in sched.active():
            if slot not in states or states[slot][0] is not req:
                # (re)prefill this slot token by token — a prefix-cache hit
                # would let production skip req.cached_blocks * page tokens
                st = model.init_decode_state(1, smax=smax)
                tok = torch.as_tensor(req.tokens[None, :], dtype=torch.int64,
                                      device=dev)
                for t in range(req.tokens.shape[0]):
                    logits, st = model.decode_step(params, st,
                                                   tok[:, t:t + 1], t)
                states[slot] = (req, st, logits)
            req, st, logits = states[slot]
            nxt = int(torch.argmax(logits[0, -1]))
            sched.complete_token(slot, nxt)
            if not req.done:
                logits, st = model.decode_step(
                    params, st, torch.full((1, 1), nxt, device=dev),
                    req.pos - 1)
                states[slot] = (req, st, logits)
            else:
                states.pop(slot, None)
                outs[req.rid] = list(req.out)
    return outs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--shared-prefix", type=int, default=16,
                    help="tokens of shared system prompt (prefix-cache hits)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the kernels) or cpu (plain versions)")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth of the model (default: the config's)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name}: {cfg.family} has no decode state")
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    smax = args.prompt_len + args.max_new
    sched = Scheduler(n_slots=args.slots, n_pages=1024, page_size=PAGE,
                      device=model.device)
    for req in make_requests(cfg.vocab, args.requests, args.prompt_len,
                             args.shared_prefix, args.max_new):
        sched.submit(req)
    t0 = time.perf_counter()
    outs = serve(model, params, sched, smax)
    wall = time.perf_counter() - t0
    hit_rate = sched.stats["prefix_hits"] / max(
        sched.stats["prefix_hits"] + sched.stats["prefix_misses"], 1)
    print(f"served {len(outs)} requests in {wall:.3f} s on {model.device}; "
          f"prefix-cache hit rate {hit_rate:.2f}; stats {sched.stats}")
    return sched.stats


if __name__ == "__main__":
    main()
