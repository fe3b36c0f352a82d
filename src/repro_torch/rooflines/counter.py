"""The dry-run's accounting of one step (the port's counterpart of
``repro.rooflines.hlo_parser``, which reads compiled, partitioned HLO).

* **Matrix-product FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``
  over the port's own step -- forward; for training forward, backward
  (each block recomputed under ``remat="block"``, as the reference's
  ``jax.checkpoint`` recomputes it) and AdamW -- on meta tensors, so it
  needs no memory and no card.  It counts the products PyTorch runs
  (``mm``, ``bmm``, ``einsum``'s products, attention), which is what the
  reference's ``parse_hlo`` counts as ``dot_flops``.  ``count_flops``
  counts models one and two blocks deep (the hybrid: one and two
  (rec, rec, attn) triples, and one triple plus one tail layer) and scales
  the block's count to the full depth: every block of a family does the
  same work.
* **HBM bytes**: ``argument_bytes`` adds each device's share of the step's
  arguments (parameters, AdamW state, batch, decode state) from its
  sharding's local shape: a lower bound on the step's traffic, since a
  step reads each argument at least once and activations come on top.
* **Collective bytes**: ``wire_bytes`` holds the ring formulas the
  reference applies to each collective of its HLO; the port has no
  compiled program to read collectives from, so the dry-run records
  ``None`` for them.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.dist.sharding import (batch_shardings,
                                       decode_state_shardings,
                                       param_shardings)
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         tree_leaves, tree_map)

__all__ = ["count_step_flops", "count_flops", "argument_bytes", "wire_bytes"]


def _run_step(model: Model, kind: str, seq: int, global_batch: int) -> None:
    """One ``kind`` step of ``model`` on meta tensors."""
    cfg = model.cfg
    params = model.init_abstract()
    if kind == "train":
        params = tree_map(lambda p: p.requires_grad_(True), params)
        loss, _ = model.loss_fn(params, model.input_specs(
            "train", seq, global_batch))
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        it = iter(grads)
        with torch.no_grad():
            params = tree_map(lambda p: p.detach(), params)
            adamw_update(params, tree_map(lambda _: next(it), params),
                         adamw_init(params))
    elif kind == "prefill":
        batch = model.input_specs("prefill", seq, global_batch)
        with torch.no_grad():
            if cfg.family == "encoder":
                tfm.forward(cfg, params, batch["tokens"],
                            batch.get("frontend"))
            else:
                model.prefill(params, batch["tokens"], batch.get("frontend"))
    elif kind == "decode":
        specs = model.input_specs("decode", seq, global_batch)
        with torch.no_grad():
            model.decode_step(params, specs["state"],
                              specs["token"].long(), 0)
    else:
        raise ValueError(kind)


def count_step_flops(cfg, kind: str, seq: int, global_batch: int) -> int:
    """The matrix-product FLOPs of one ``kind`` step of ``cfg`` at its own
    depth, counted on meta tensors."""
    with FlopCounterMode(display=False) as fc:
        _run_step(Model(cfg, device="meta"), kind, seq, global_batch)
    return int(fc.get_total_flops())


def _depths(cfg) -> dict[str, int]:
    """The reduced depths ``count_flops`` counts: ``one`` and ``two``
    blocks, and for a hybrid with a tail, ``tail`` (one triple and one
    tail layer)."""
    if cfg.family == "hybrid":
        out = {"one": 3, "two": 6}
        if cfg.n_layers % 3:
            out["tail"] = 4
        return out
    return {"one": 1, "two": 2}


def count_flops(cfg, kind: str, seq: int, global_batch: int) -> int:
    """``count_step_flops`` at the full depth, from the counts of one and
    two blocks: the embedding, head and loss once, plus the block's count
    times the number of blocks (and, in a hybrid, the tail layer's count
    times the tail's length).  The attention runs as one chunk of the whole
    sequence (``attn_chunk = seq``): the plain chunked attention computes
    every (query chunk, key chunk) pair, masked or not, so its products'
    FLOPs do not depend on the chunk, and one chunk counts them without a
    Python loop over 32 x 32 pairs a layer at 32k positions."""
    cfg = dataclasses.replace(cfg, attn_chunk=max(seq, cfg.attn_chunk))
    n = {k: count_step_flops(dataclasses.replace(cfg, n_layers=L), kind,
                             seq, global_batch)
         for k, L in _depths(cfg).items()}
    block = n["two"] - n["one"]
    if cfg.family == "hybrid":
        nt, rem = divmod(cfg.n_layers, 3)
        tail = n["tail"] - n["one"] if rem else 0
        return n["one"] + (nt - 1) * block + rem * tail
    return n["one"] + (cfg.n_layers - 1) * block


def _nbytes(sharding, dtype) -> int:
    n = 1
    for s in sharding.local_shape:
        n *= s
    return n * torch.empty((), dtype=dtype).element_size()


def argument_bytes(model: Model, kind: str, seq: int, global_batch: int,
                   mesh) -> dict[str, int]:
    """Each device's bytes of the step's arguments, by the local shapes of
    their shardings on ``mesh``: ``params`` (and for training ``opt_state``,
    the f32 AdamW moments and the step counter, laid out as the
    parameters), ``batch`` (``decode_state`` and the token for decode), and
    ``argument_size_in_bytes``, their sum."""
    params = model.init_abstract()
    psh = param_shardings(params, model.param_axes(), mesh)
    out = {"params": sum(_nbytes(s, p.dtype) for s, p in zip(
        tree_leaves(psh), tree_leaves(params)))}
    if kind == "train":
        out["opt_state"] = 2 * sum(_nbytes(s, torch.float32)
                                   for s in tree_leaves(psh)) + 4
    spec = model.input_specs(kind, seq, global_batch)
    if kind == "decode":
        st = spec.pop("state")
        out["decode_state"] = sum(_nbytes(s, x.dtype) for s, x in zip(
            tree_leaves(decode_state_shardings(st, mesh)), tree_leaves(st)))
        spec.pop("pos")
    out["batch"] = sum(_nbytes(s, x.dtype) for s, x in zip(
        tree_leaves(batch_shardings(spec, mesh)), tree_leaves(spec)))
    out["argument_size_in_bytes"] = sum(out.values())
    return out


def wire_bytes(kind: str, out_bytes: float, group: int) -> float:
    """Bytes one device sends for a ring collective of ``kind`` over
    ``group`` devices whose output is ``out_bytes`` a device (the
    reference's formulas, ``hlo_parser.py:192-201``)."""
    g = max(group, 2)
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "all-reduce":
        return 2 * out_bytes * (g - 1) / g
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    if kind == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective {kind!r}")
