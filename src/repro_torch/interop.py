"""Carry engine state between the JAX reference and the port.

The reference's ``StoreState`` (``ptr``, ``meta``, ``epoch``, ``heap``,
``heap_top``) and ``CreditState`` (``credit``, ``retry_record``) travel as
numpy arrays: ``*_from_numpy`` builds the port's tensors on a device and
``*_to_numpy`` returns a dict of numpy arrays with the same field names, so
``repro.core.engine.StoreState(**state_to_numpy(s))`` rebuilds a reference
state (after ``jnp.asarray`` of each field).  A run can so switch between
the two implementations at a window boundary.

A model's parameter tree (the reference's ``unbox``ed tree as numpy
arrays: nested dicts of arrays) travels the same way: ``params_from_numpy``
builds the port's tensors with the same keys, shapes and dtypes, and
``params_to_numpy`` returns numpy arrays, bf16 ones as exact float32.  bf16
arrays come in as their bits: the reference's numpy bf16 dtype
(``ml_dtypes``) is recognised by its name and reinterpreted through int16,
so the port never imports it.

The protocol simulator's ``SimState`` travels as a dict of numpy arrays
keyed by its field names, ``net`` a dict keyed by ``NetState``'s:
``sim_state_from_numpy`` builds the port's state from the reference's after
any tick, and ``sim_state_to_numpy`` gives it back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.credits import CreditState
from repro_torch.core.engine import StoreState
from repro_torch.core.protocol import SimState
from repro_torch.core.simnet import NetState
from repro_torch.core.types import as_device, as_i32, to_numpy

__all__ = ["state_from_numpy", "state_to_numpy", "credits_from_numpy",
           "credits_to_numpy", "params_from_numpy", "params_to_numpy",
           "sim_state_from_numpy", "sim_state_to_numpy"]


def state_from_numpy(ptr, meta, epoch, heap, heap_top,
                     device: str | torch.device = "cuda") -> StoreState:
    return StoreState(ptr=as_i32(ptr, device), meta=as_i32(meta, device),
                      epoch=as_i32(epoch, device), heap=as_i32(heap, device),
                      heap_top=as_i32(heap_top, device).reshape(()))


def state_to_numpy(state: StoreState) -> dict[str, np.ndarray]:
    return {f.name: to_numpy(getattr(state, f.name))
            for f in dataclasses.fields(StoreState)}


def credits_from_numpy(credit, retry_record,
                       device: str | torch.device = "cuda") -> CreditState:
    return CreditState(credit=as_i32(credit, device),
                       retry_record=as_i32(retry_record, device))


def credits_to_numpy(credits: CreditState) -> dict[str, np.ndarray]:
    return {f.name: to_numpy(getattr(credits, f.name))
            for f in dataclasses.fields(CreditState)}


def params_from_numpy(tree, device: str | torch.device = "cuda"):
    """A nested dict of numpy arrays (bf16 included) -> the same dict of
    tensors on ``device``, dtypes kept."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.array(tree)                 # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(as_device(device))


def params_to_numpy(tree):
    """A nested dict of tensors -> the same dict of numpy arrays.  bf16
    tensors become float32 arrays (exact: a cast back to bf16 gives the
    same bits)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def sim_state_from_numpy(state: dict, device: str | torch.device = "cuda"
                         ) -> SimState:
    """A ``SimState`` as a dict of int32 arrays (``net`` a dict of the
    ``NetState`` fields) -> the port's ``SimState`` on ``device``."""
    out = {}
    for f in dataclasses.fields(SimState):
        v = state[f.name]
        if f.name == "net":
            out["net"] = NetState(**{g.name: as_i32(v[g.name], device)
                                     for g in dataclasses.fields(NetState)})
        else:
            out[f.name] = as_i32(v, device)
    return SimState(**out)


def sim_state_to_numpy(state: SimState) -> dict:
    """The port's ``SimState`` -> a dict of numpy arrays, ``net`` a dict."""
    out = {f.name: to_numpy(getattr(state, f.name))
           for f in dataclasses.fields(SimState) if f.name != "net"}
    out["net"] = {g.name: to_numpy(getattr(state.net, g.name))
                  for g in dataclasses.fields(NetState)}
    return out
