"""Launcher of the ``wc_combine`` CUDA kernel (``csrc/wc_combine.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/wc_combine/wc_combine.py``
(``wc_combine``, ``pallas_call`` at :69) and its padded wrapper ``ops.py:22``.
Bound: 10 bytes per element (4 in, 1 + 1 + 4 out) over 3.35 TB/s, 12 ns at
the engine's N = 4096.  Design: one thread per element and no cross-block
carry — ``rank`` comes from a binary search for the run start — so the
kernel is a single launch for any N, with no padding; at the engine's sizes
the launch latency, not the bound, sets its time.

``wc_combine_cuda`` launches the kernel on CUDA tensors and raises on any
other; ``combine._first_last_rank`` sends CPU tensors to the plain version
(``ref.py``).  ``counter.count`` grows by one per launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wc_combine.ref import wc_combine_ref

__all__ = ["wc_combine_cuda", "wc_combine_ref", "counter"]

counter = build.LaunchCounter("wc_combine")

_P = ctypes.c_void_p
_SIGNATURES = {"wc_combine_launch": (
    ctypes.c_int, [ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, _P])}


def wc_combine_cuda(keys_sorted: torch.Tensor):
    """``(is_first, is_last, rank)`` of a sorted ``(N,)`` int32 CUDA key
    array, by the CUDA kernel."""
    build.require_cuda("wc_combine", keys_sorted, dtypes=(torch.int32,))
    n = keys_sorted.shape[0]
    dev = keys_sorted.device
    first = torch.empty((n,), dtype=torch.bool, device=dev)
    last = torch.empty((n,), dtype=torch.bool, device=dev)
    rank = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = build.library("wc_combine", _SIGNATURES)
    err = lib.wc_combine_launch(dev.index, keys_sorted.data_ptr(),
                                first.data_ptr(), last.data_ptr(),
                                rank.data_ptr(), n, build.stream_of(keys_sorted))
    build.check(lib, err, "wc_combine")
    counter.count += 1
    return first, last, rank
