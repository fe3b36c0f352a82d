"""The port on the GPU: the hand-written CUDA kernels against their plain
PyTorch versions, and the engine path through the kernels against the same
path through the plain versions.  Every test here is marked ``cuda`` and
skips without a GPU.  This file imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import runner  # noqa: E402
from repro_torch.core.types import SyncMode  # noqa: E402
from repro_torch.kernels.scan_probe import ops as sp  # noqa: E402
from repro_torch.kernels.wc_combine import ops as wcc  # noqa: E402
from repro_torch.stores import PointerArray, SmartART  # noqa: E402
from repro_torch.workloads.ycsb import (WORKLOADS, YCSB,  # noqa: E402
                                        generate_window_stream,
                                        generate_ycsb_stream)

pytestmark = pytest.mark.cuda
BIG = 2**31 - 1
LAYOUTS = ["distinct", "giant_run", "all_invalid", "sentinel_tail", "dup_heavy"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the hand-written kernels run only on a GPU")
    return torch.device("cuda", 0)


def sorted_keys(layout: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if layout == "distinct":
        return np.arange(n, dtype=np.int32) * 5 - 7
    if layout == "giant_run":
        return np.full(n, 42, np.int32)
    if layout == "all_invalid":
        return np.full(n, BIG, np.int32)
    if layout == "sentinel_tail":
        k = np.sort(rng.integers(-50, 50, n)).astype(np.int32)
        k[n - n // 3:] = BIG
        return k
    return np.sort(rng.integers(0, max(n // 6, 1), n)).astype(np.int32)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", [1, 1000, 4096, 34816, 69632, 1 << 20])
def test_kernels_bit_equal_plain_on_card(cuda_device, layout, n):
    rng = np.random.default_rng(n)
    k = torch.as_tensor(sorted_keys(layout, n, seed=3), device=cuda_device)
    sc = torch.as_tensor(rng.integers(-1, 2, n).astype(np.int32),
                         device=cuda_device)
    wr = torch.as_tensor(rng.random(n) < 0.3, device=cuda_device)
    ei = torch.as_tensor(rng.random(n) < 0.5, device=cuda_device)
    c0, c1 = wcc.counter.count, sp.counter.count
    for got, want in ((wcc.wc_combine_cuda(k), wcc.wc_combine_ref(k)),
                      (sp.scan_probe_cuda(k, sc, wr, ei),
                       sp.scan_probe_ref(k, sc, wr, ei))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert (wcc.counter.count, sp.counter.count) == (c0 + 1, c1 + 1)


def test_wrappers_check_their_inputs_on_card(cuda_device):
    k = torch.zeros(16, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        wcc.wc_combine_cuda(k)
    k32 = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        wcc.wc_combine_cuda(k32[::2])
    with pytest.raises(ValueError, match="bool"):
        sp.scan_probe_cuda(k32, k32, k32, k32.bool())


def _equal_trees(a, b):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


@pytest.mark.parametrize("mode", list(SyncMode), ids=lambda m: m.name)
def test_engine_path_kernels_equal_plain_on_card(cuda_device, mode):
    """``engine_json --fast`` and a YCSB E stream on the card: the run
    through the kernels equals the run through their plain versions."""
    n_slots, b, windows = 4096, 1024, 4
    ops = generate_window_stream(WORKLOADS["write-intensive"], windows, b,
                                 n_slots, b)
    stream = runner.make_stream(ops.kinds, ops.keys % n_slots, ops.values,
                                n_cns=16, device=cuda_device)
    pk = np.arange(n_slots)
    out = {}
    for backend in ("auto", "torch"):
        c0 = wcc.counter.count
        pa = PointerArray.create(n_slots, mode=mode, device=cuda_device,
                                 kernel_backend=backend).populate(pk, pk)
        pa, res, io = pa.apply_stream(stream, io_per_window=True)
        out[backend] = (res, io, pa.view())
        assert wcc.counter.count - c0 == (windows if backend == "auto" else 0)
    _equal_trees(out["auto"][0], out["torch"][0])
    _equal_trees(out["auto"][1], out["torch"][1])
    e = generate_ycsb_stream(YCSB["E"], 3, 512, 1000, 64, seed=1)
    outs = []
    for backend in ("auto", "torch"):
        c0 = sp.counter.count
        sa = SmartART.create(key_bits=11, mode=mode, credit_table=512,
                             device=cuda_device,
                             kernel_backend=backend).populate(pk[:1000],
                                                              pk[:1000])
        sa, res, io = sa.apply_stream(e.kinds, e.keys, e.values, n_cns=8)
        outs.append((res, io))
        assert sp.counter.count - c0 == (3 if backend == "auto" else 0)
    _equal_trees(outs[0][0], outs[1][0])
    _equal_trees(outs[0][1], outs[1][1])
    assert int(outs[0][0].rows.sum()) > 0
