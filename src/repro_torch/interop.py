"""Carry engine state between the JAX reference and the port.

The reference's ``StoreState`` (``ptr``, ``meta``, ``epoch``, ``heap``,
``heap_top``) and ``CreditState`` (``credit``, ``retry_record``) travel as
numpy arrays: ``*_from_numpy`` builds the port's tensors on a device and
``*_to_numpy`` returns a dict of numpy arrays with the same field names, so
``repro.core.engine.StoreState(**state_to_numpy(s))`` rebuilds a reference
state (after ``jnp.asarray`` of each field).  A run can so switch between
the two implementations at a window boundary.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.credits import CreditState
from repro_torch.core.engine import StoreState
from repro_torch.core.types import as_i32, to_numpy

__all__ = ["state_from_numpy", "state_to_numpy", "credits_from_numpy",
           "credits_to_numpy"]


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
