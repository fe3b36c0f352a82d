"""Dtype and host-sync audit of the port's device paths (analysis pass 1:
the port's stand-in for the reference's ``jaxpr_check``).

The reference audits the jaxpr of its jitted entry points.  The port has
no graph to read before it runs, so this pass runs the paths under a
``TorchDispatchMode`` that sees every aten op they dispatch (a *census*)
and fails on

* a ``float64`` tensor, in or out of any op, and any dtype outside
  ``DTYPES`` (the engine and the simulator are int32 with bool masks and
  int64 sort/scatter indices), naming the first op that carried it;
* any op that makes the host wait for the device (``SYNC_OPS``:
  ``.item()`` is ``_local_scalar_dense``; ``nonzero``, ``masked_select``,
  ``unique`` size their output from the data; ``masked_fill`` with a
  tensor value reads it on the host), and indexing with a
  boolean mask (``aten.index``/``index_put_`` with a bool index, which
  calls ``nonzero`` inside).  A CUDA graph cannot capture any of these.

``run()`` audits the engine's window loop (``runner.run_windows``, YCSB E,
SCAN probe on, all four SyncModes) and one simulator ``tick`` per mode.
``runner.modeled_throughput``'s ``.item()`` calls run after the loop and
are outside the audit.  On a card ``chip_smoke.py`` also runs the graphed
simulator and a window loop under ``torch.cuda.set_sync_debug_mode("error")``.

The reference's donation-pair and collective censuses have no counterpart:
PyTorch has no buffer donation, and the sharded store's 20 sums per window
are counted by ``tests/test_torch_mesh.py``.
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import Violation

__all__ = ["DTYPES", "SYNC_OPS", "Census", "census", "check", "run"]

# the dtypes of the port's engine and simulator tensors
DTYPES = frozenset({torch.int32, torch.int64, torch.bool})
# aten ops that wait for the device to finish before they return (the
# masked fills with a tensor value read that value on the host)
SYNC_OPS = frozenset({
    "aten._local_scalar_dense.default", "aten.nonzero.default",
    "aten.masked_select.default", "aten.is_nonzero.default",
    "aten.equal.default", "aten._unique2.default", "aten.unique_dim.default",
    "aten.unique_consecutive.default", "aten.repeat_interleave.Tensor",
    "aten.allclose.default", "aten.masked_fill.Tensor",
    "aten.masked_fill_.Tensor"})
_MASK_INDEXING = frozenset({"aten.index.Tensor", "aten.index_put.default",
                            "aten.index_put_.default",
                            "aten._index_put_impl_.default"})


@dataclasses.dataclass
class Census:
    """Every aten op one run dispatched: counts by op, the first op that
    carried each dtype, and the host-sync ops in dispatch order."""
    ops: Counter = dataclasses.field(default_factory=Counter)
    dtype_first_op: dict = dataclasses.field(default_factory=dict)
    syncs: list = dataclasses.field(default_factory=list)

    @property
    def n_ops(self) -> int:
        return sum(self.ops.values())


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


class _CensusMode(TorchDispatchMode):
    def __init__(self, out: Census):
        super().__init__()
        self.out = out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        self.out.ops[name] += 1
        if name in SYNC_OPS:
            self.out.syncs.append(name)
        elif name in _MASK_INDEXING and any(
                t.dtype == torch.bool for t in _tensors(args[1])):
            self.out.syncs.append(f"{name} (boolean-mask index)")
        result = func(*args, **kwargs)
        for t in _tensors((args, kwargs, result)):
            self.out.dtype_first_op.setdefault(t.dtype, name)
        return result


def census(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), Census)`` of the ops ``fn`` dispatched."""
    out = Census()
    with _CensusMode(out):
        result = fn(*args, **kwargs)
    return result, out


def check(c: Census, target: str) -> list[Violation]:
    """The violations of one census: stray dtypes and host syncs."""
    out = []
    for dt, op in sorted(c.dtype_first_op.items(), key=lambda kv: str(kv[0])):
        if dt == torch.float64:
            out.append(Violation("device_check", target,
                                 f"float64 tensor at {op}"))
        elif dt not in DTYPES:
            out.append(Violation("device_check", target,
                                 f"dtype {dt} outside the documented set "
                                 f"at {op}"))
    for op, n in sorted(Counter(c.syncs).items()):
        out.append(Violation("device_check", target,
                             f"host sync: {op} x{n}"))
    return out


def _window_loop_case(mode, device):
    """A YCSB E window stream (SCAN on) through ``runner.run_windows``."""
    import numpy as np
    from repro_torch.core import credits, engine, runner
    from repro_torch.core.types import EngineConfig
    from repro_torch.workloads.ycsb import YCSB, generate_ycsb_stream

    w, b, n_cns, n_keys = 3, 256, 8, 512
    ops = generate_ycsb_stream(YCSB["E"], w, b, n_keys, 64, seed=5)
    cfg = EngineConfig(n_slots=n_keys + w * b, heap_slots=n_keys + 2 * w * b,
                       mode=mode, scan_max=16)
    keys = np.arange(n_keys)
    state = engine.populate(cfg, engine.store_init(cfg, device), keys, keys)
    stream = runner.make_stream(ops.kinds, ops.keys, ops.values, n_cns,
                                device=device)
    return (runner.run_windows, cfg, state, credits.credit_init(256, device),
            stream)


def _tick_case(mode, device):
    """One simulator tick from a state 40 ticks into a run."""
    from repro_torch.core import protocol, sim
    from repro_torch.core.simnet import SimParams
    from repro_torch.workloads.ycsb import WORKLOADS

    p = SimParams(n_lanes=64, max_ops=64, ticks=40, h_bits=8, hc_bits=6,
                  hl_bits=6)
    streams = sim.make_streams(p, WORKLOADS["write-intensive"], 1000,
                               device=device)
    state = sim._run(p, mode, streams, 48)
    t = torch.full((), p.ticks, dtype=torch.int32, device=state.phase.device)
    return protocol.tick, p, mode, streams, state, t


def run(notes: list[str] | None = None, device="cuda") -> list[Violation]:
    """Census the window loop and one tick, each in all four modes."""
    from repro_torch.core.types import SyncMode, as_device

    dev = as_device(device)
    out = []
    counts = []
    for what, case in (("runner.run_windows", _window_loop_case),
                       ("protocol.tick", _tick_case)):
        for mode in SyncMode:
            fn, *args = case(mode, dev)
            _, c = census(fn, *args)
            out.extend(check(c, f"{what} [{mode.name}]"))
            counts.append(c.n_ops)
    if notes is not None:
        notes.append(f"device_check: {len(counts)} paths on {dev}, "
                     f"{min(counts)}-{max(counts)} aten ops each")
    return out
