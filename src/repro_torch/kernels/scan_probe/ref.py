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

__all__ = ["scan_probe_ref", "pack_status", "unpack_status", "FLAG_AGGREGATE",
           "FLAG_PREFIX", "EPOCH_SHIFT", "EPOCH_BITS", "EPOCH_MAX", "W_MAX"]


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


# The kernel's 64-bit status word (``csrc/scan_probe.cu``), one per tile:
# flag (bits 0-1: 0 not written, 1 aggregate, 2 inclusive prefix), head
# (bit 2), c + 1 (bits 3-4, c in {-1, 0, 1}), w (bits 5-35), and the call's
# epoch (bits 36-63).  A word whose epoch is not the reader's reads as not
# ready.  These twins of the kernel's pack and unpack serve the tests.
FLAG_AGGREGATE, FLAG_PREFIX = 1, 2
EPOCH_SHIFT = 36
EPOCH_BITS = 64 - EPOCH_SHIFT
EPOCH_MAX = 2**EPOCH_BITS - 1
W_MAX = 2**31 - 1


def pack_status(flag: int, head: int, w: int, c: int, epoch: int) -> int:
    """The status word (an unsigned 64-bit value) of a tile."""
    if not (flag in (FLAG_AGGREGATE, FLAG_PREFIX) and head in (0, 1)
            and 0 <= w <= W_MAX and c in (-1, 0, 1)
            and 0 < epoch <= EPOCH_MAX):
        raise ValueError(f"status word out of range: flag={flag} head={head} "
                         f"w={w} c={c} epoch={epoch}")
    return (flag | head << 2 | (c + 1) << 3 | w << 5
            | epoch << EPOCH_SHIFT)


def unpack_status(word: int) -> tuple[int, int, int, int, int]:
    """``(flag, head, w, c, epoch)`` of a status word (an int64 read back
    from the scratch is taken as its unsigned 64-bit value)."""
    word &= 2**64 - 1
    return (word & 3, word >> 2 & 1, word >> 5 & W_MAX,
            (word >> 3 & 3) - 1, word >> EPOCH_SHIFT)
