"""Launcher of the ``scan_probe`` CUDA kernel (``csrc/scan_probe.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/scan_probe/scan_probe.py``
(``scan_probe``, ``pallas_call`` at :84) and its padded wrapper ``ops.py:22``.
Bound: 15 bytes per lane (4 key + 4 setcode + 1 writer + 1 e_init in,
1 + 4 out) over 3.35 TB/s, 0.31 us at the engine's N = 69,632.  Design: the
TPU kernel's in-order SMEM carry becomes a device-wide segmented scan in
three launches (tile aggregates, one-block prefix over them, tile scan +
outputs), so every lane is read twice and written once; at the engine's
sizes the three launches, not the bound, set its time.

``scan_probe_cuda`` launches the kernel on CUDA tensors and raises on any
other; ``engine._probe_sweep`` sends CPU tensors to the plain version
(``ref.py``).  ``counter.count`` grows by one per call (one call = three
kernel launches = one count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.scan_probe.ref import scan_probe_ref

__all__ = ["scan_probe_cuda", "scan_probe_ref", "counter"]

counter = build.LaunchCounter("scan_probe")

TILE = 1024                      # lanes per block in csrc/scan_probe.cu

_P = ctypes.c_void_p
_SIGNATURES = {"scan_probe_launch": (
    ctypes.c_int, [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P,
                   ctypes.c_int, _P])}


def scan_probe_cuda(keys_sorted, setcode, writer, e_init):
    """``(e_before, waits)`` over lanes sorted by (key, pos), by the CUDA
    kernel (see ``ref.py`` for the contract): int32 keys/setcode, bool
    writer/e_init, all on one card."""
    build.require_cuda("scan_probe", keys_sorted, setcode, writer, e_init,
                       dtypes=(torch.int32, torch.int32, torch.bool,
                               torch.bool))
    n = keys_sorted.shape[0]
    dev = keys_sorted.device
    e_before = torch.empty((n,), dtype=torch.bool, device=dev)
    waits = torch.empty((n,), dtype=torch.int32, device=dev)
    n_tiles = max((n + TILE - 1) // TILE, 1)
    scratch = torch.empty((2, 3 * n_tiles), dtype=torch.int32, device=dev)
    lib = build.library("scan_probe", _SIGNATURES)
    err = lib.scan_probe_launch(
        dev.index, keys_sorted.data_ptr(), setcode.data_ptr(),
        writer.data_ptr(), e_init.data_ptr(), e_before.data_ptr(),
        waits.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(), n,
        build.stream_of(keys_sorted))
    build.check(lib, err, "scan_probe")
    counter.count += 1
    return e_before, waits
