"""Launcher of the ``wc_combine`` CUDA kernel (``csrc/wc_combine.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/wc_combine/wc_combine.py``
(``wc_combine``, ``pallas_call`` at :69) and its padded wrapper ``ops.py:22``.
Bound: 10 bytes per element (4 in, 1 + 1 + 4 out) over 3.35 TB/s, 12 ns at
the engine's N = 4096.  Design: one launch, a tiled single pass — a block
owns ``TILE`` = 128 threads x 4 keys, loads them with 16-byte loads, takes
its run boundaries from the neighbours and its ranks from a max-scan of
head indices; when its first key continues an earlier tile's run, one warp
finds that run's start in the 32 keys before the tile or by a 32-way
cooperative search (about log32 N dependent reads), so no block waits on
another.  At the engine's sizes the launch latency, not the bound, sets its
time.

``wc_combine_cuda`` launches the kernel on CUDA tensors and raises on any
other; ``combine._first_last_rank`` sends CPU tensors to the plain version
(``ref.py``).  ``counter`` counts one per launch (none for N = 0, which
launches nothing), tallied by N.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wc_combine.ref import wc_combine_ref

__all__ = ["wc_combine_cuda", "wc_combine_ref", "counter", "TILE"]

counter = build.LaunchCounter("wc_combine")

THREADS, PER_THREAD = 128, 4     # kThreads, kPerThread of csrc/wc_combine.cu
TILE = THREADS * PER_THREAD      # keys per block

_P = ctypes.c_void_p
_SIGNATURES = {"wc_combine_launch": (
    ctypes.c_int, [ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, _P])}


@functools.cache
def _launcher():
    lib = build.library("wc_combine", _SIGNATURES)
    return lib, lib.wc_combine_launch


def wc_combine_cuda(keys_sorted: torch.Tensor):
    """``(is_first, is_last, rank)`` of a sorted ``(N,)`` int32 CUDA key
    array, by the CUDA kernel.  The two flag arrays are rows of one bool
    allocation, each starting on a 16-byte boundary."""
    build.require_cuda("wc_combine", keys_sorted, dtypes=(torch.int32,))
    n = keys_sorted.shape[0]
    dev = keys_sorted.device
    n16 = -(-n // 16) * 16
    flags = torch.empty((2, n16), dtype=torch.bool, device=dev)
    rank = torch.empty((n,), dtype=torch.int32, device=dev)
    first, last = (flags if n16 == n else flags[:, :n]).unbind(0)
    if n == 0:
        return first, last, rank
    lib, launch = _launcher()
    err = launch(dev.index, keys_sorted.data_ptr(), first.data_ptr(),
                 last.data_ptr(), rank.data_ptr(), n,
                 build.stream_of(keys_sorted))
    build.check(lib, err, "wc_combine")
    counter.add(n)
    return first, last, rank
