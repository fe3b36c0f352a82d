"""Plain PyTorch version of ``scan_probe`` (port of
``repro.kernels.scan_probe.ref``): the CPU path of the engine's seam and the
yardstick the CUDA kernel is held to, bit for bit.

Contract (all ``(N,)``, lanes sorted by (key, pos)): ``keys_sorted`` int32;
``setcode`` int32 in {-1 keep, 0 set-absent, 1 set-present}; ``writer``
bool (lane holds the slot lock); ``e_init`` bool (existence at window
start).  Returns ``(e_before bool, waits int32)``.
"""
from __future__ import annotations

import torch

__all__ = ["scan_probe_ref"]


def scan_probe_ref(keys_sorted, setcode, writer, e_init):
    k = keys_sorted
    n = k.shape[0]
    dev = k.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       k[1:] != k[:-1]])
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    # last setter strictly before me, in-run: encode (2*idx + bit), take a
    # running max; the decode counts only if its lane sits in my run
    enc = torch.where(setcode >= 0, 2 * idx + setcode, -1)
    g = torch.cummax(enc, 0).values
    g_excl = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev),
                        g[:-1]])
    has = (g_excl >= 0) & ((g_excl >> 1) >= start)
    e_before = torch.where(has, (g_excl & 1) == 1, e_init)
    # writers strictly ahead of me in my run
    w_i = writer.to(torch.int32)
    cex = torch.cumsum(w_i, 0, dtype=torch.int32) - w_i
    base = torch.cummax(torch.where(first, cex, 0), 0).values
    return e_before, cex - base
