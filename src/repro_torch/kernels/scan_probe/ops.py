"""Launcher of the ``scan_probe`` CUDA kernel (``csrc/scan_probe.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/scan_probe/scan_probe.py``
(``scan_probe``, ``pallas_call`` at :84) and its padded wrapper ``ops.py:22``.
Bound: 15 bytes per lane (4 key + 4 setcode + 1 writer + 1 e_init in,
1 + 4 out) over 3.35 TB/s, 0.31 us at the engine's N = 69,632.  Design: the
TPU kernel's in-order SMEM carry becomes a device-wide segmented scan in ONE
launch with decoupled look-back: each block takes a ``TILE``-lane tile from
a ticket counter, publishes its aggregate as one 64-bit status word, and
looks back over its predecessors' words only when its first lane continues
a run, stopping at the first inclusive prefix or run head.  Every lane is
read once and written once.

The ticket counter and the status words are scratch that persists here,
one per (device, stream).  The counter wraps back to 0 on the device at the
end of every launch; the host hands each launch a fresh ``epoch``, so a
word left by an earlier call reads as not ready and no memset runs between
calls.  The scratch is zeroed when it grows and when the epoch wraps.  The
epoch lives on the host, so a call inside a CUDA graph capture (whose
replays would all reuse one epoch) raises.

``scan_probe_cuda`` launches the kernel on CUDA tensors and raises on any
other; ``engine._probe_sweep`` sends CPU tensors to the plain version
(``ref.py``).  ``counter`` counts one per call, which is one launch (none
for N = 0, which launches nothing), tallied by N.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.scan_probe.ref import EPOCH_MAX, scan_probe_ref

__all__ = ["scan_probe_cuda", "scan_probe_ref", "counter", "TILE",
           "scratch_of"]

counter = build.LaunchCounter("scan_probe")

THREADS, PER_THREAD = 128, 4     # kThreads, kPerThread of csrc/scan_probe.cu
TILE = THREADS * PER_THREAD      # lanes per block
MIN_TILES = 64                   # the first scratch's status words

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"scan_probe_launch": (
    _I, [_I, _P, _P, _P, _P, _P, _P, _P, ctypes.c_uint, _I, _P])}


class Scratch:
    """The ticket counter (``buf[0]``, 0 between launches) and one status
    word per tile (``buf[1:]``) of one (device, stream); ``epoch`` is the
    last launch's epoch."""

    def __init__(self, device: torch.device, tiles: int):
        self.buf = torch.zeros((1 + tiles,), dtype=torch.int64, device=device)
        self.tiles = tiles
        self.epoch = 0

    def next_epoch(self) -> int:
        """The next launch's epoch, 1 to ``EPOCH_MAX``; at the wrap the
        words are zeroed first (on the current stream), so no word of an
        earlier cycle can carry the new epoch."""
        if self.epoch == EPOCH_MAX:
            self.buf.zero_()
            self.epoch = 0
        self.epoch += 1
        return self.epoch


_SCRATCH: dict[tuple[int, int], Scratch] = {}


def scratch_of(device: torch.device, stream: int, n_tiles: int) -> Scratch:
    """The scratch of ``(device, stream)``, with room for ``n_tiles`` status
    words: made (zeroed) at first use, remade twice as large when a call
    needs more tiles than it holds."""
    key = (device.index, stream)
    s = _SCRATCH.get(key)
    if s is None or s.tiles < n_tiles:
        s = Scratch(device, max(n_tiles, MIN_TILES,
                                2 * s.tiles if s is not None else 0))
        _SCRATCH[key] = s
    return s


@functools.cache
def _launcher():
    lib = build.library("scan_probe", _SIGNATURES)
    return lib, lib.scan_probe_launch


def scan_probe_cuda(keys_sorted, setcode, writer, e_init):
    """``(e_before, waits)`` over lanes sorted by (key, pos), by the CUDA
    kernel (see ``ref.py`` for the contract): int32 keys/setcode, bool
    writer/e_init, all on one card."""
    build.require_cuda("scan_probe", keys_sorted, setcode, writer, e_init,
                       dtypes=(torch.int32, torch.int32, torch.bool,
                               torch.bool))
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("scan_probe: its epoch is kept on the host, so a "
                           "captured launch cannot be replayed; call it "
                           "outside CUDA graph capture")
    n = keys_sorted.shape[0]
    dev = keys_sorted.device
    e_before = torch.empty((n,), dtype=torch.bool, device=dev)
    waits = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return e_before, waits
    n_tiles = -(-n // TILE)
    stream = build.stream_of(keys_sorted)
    s = scratch_of(dev, stream, n_tiles)
    epoch = s.next_epoch()
    lib, launch = _launcher()
    err = launch(dev.index, keys_sorted.data_ptr(), setcode.data_ptr(),
                 writer.data_ptr(), e_init.data_ptr(), e_before.data_ptr(),
                 waits.data_ptr(), s.buf.data_ptr(), epoch, n, stream)
    build.check(lib, err, "scan_probe")
    counter.add(n)
    return e_before, waits
