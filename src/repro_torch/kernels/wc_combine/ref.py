"""Plain PyTorch version of ``wc_combine`` (port of
``repro.kernels.wc_combine.ref``): the CPU path of the engine's seam and the
yardstick the CUDA kernel is held to, bit for bit."""
from __future__ import annotations

import torch

__all__ = ["wc_combine_ref"]


def wc_combine_ref(keys_sorted: torch.Tensor):
    """``(is_first, is_last, rank)`` of a sorted ``(N,)`` int32 key array:
    run head, run tail and 0-based position within the run."""
    k = keys_sorted
    n = k.shape[0]
    one = torch.ones((min(n, 1),), dtype=torch.bool, device=k.device)
    neq = k[1:] != k[:-1]
    first = torch.cat([one, neq])
    last = torch.cat([neq, one])
    idx = torch.arange(n, dtype=torch.int32, device=k.device)
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    return first, last, idx - start
