"""The port on the GPU: the hand-written CUDA kernels against their plain
PyTorch versions, the engine path through the kernels against the same
path through the plain versions, and the serving slice (attention kernels,
the dense model, the serve loop) on the card against the CPU.  Every test
here is marked ``cuda`` and skips without a GPU.  This file imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import runner  # noqa: E402
from repro_torch.core.types import SyncMode  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.scan_probe import ops as sp  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
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


# N = 2, TILE + 2 and 8 * TILE + 2 leave the last thread two keys (its
# scalar path at two), as the main path's N = 2 does
SWEEP_EDGES = [0, 1, 2, sp.TILE - 1, sp.TILE, sp.TILE + 1, sp.TILE + 2,
               wcc.TILE - 1, wcc.TILE, wcc.TILE + 1, 2 * wcc.TILE,
               2 * wcc.TILE + 1500, 8 * wcc.TILE + 2, 1 << 20]


def _probe_args(layout, n, seed, dev):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(sorted_keys(layout, n, seed=seed), device=dev),
            torch.as_tensor(rng.integers(-1, 2, n).astype(np.int32),
                            device=dev),
            torch.as_tensor(rng.random(n) < 0.3, device=dev),
            torch.as_tensor(rng.random(n) < 0.5, device=dev))


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", SWEEP_EDGES)
def test_sweeps_bit_equal_plain_at_tile_edges(cuda_device, layout, n):
    """Both kernels at N = 0, 1, 2, every tile edge of either kernel, a
    last thread with two keys, and 2^20; one launch per call (none at
    N = 0)."""
    args = _probe_args(layout, n, n + 5, cuda_device)
    c0, c1 = wcc.counter.count, sp.counter.count
    _same(wcc.wc_combine_cuda(args[0]), wcc.wc_combine_ref(args[0]))
    _same(sp.scan_probe_cuda(*args), sp.scan_probe_ref(*args))
    torch.cuda.synchronize()
    assert (wcc.counter.count - c0, sp.counter.count - c1) == ((n > 0,) * 2)


@pytest.mark.parametrize("n", [sp.TILE * 3 + 7, wcc.TILE * 3 + 7])
def test_sweeps_on_inputs_off_16_byte_boundaries(cuda_device, n):
    """Views that start one element in take the kernels' scalar path."""
    args = _probe_args("dup_heavy", n + 1, 9, cuda_device)
    views = tuple(a[1:] for a in args)
    assert views[0].data_ptr() % 16
    _same(wcc.wc_combine_cuda(views[0]), wcc.wc_combine_ref(views[0]))
    _same(sp.scan_probe_cuda(*views), sp.scan_probe_ref(*views))


def test_scan_probe_back_to_back_calls_share_one_scratch(cuda_device):
    """200 calls in a row with no sync between them, N alternating small
    and large, one run over every tile: a stale status word or a ticket
    counter not back at 0 would show as a wrong prefix (or a trap)."""
    sizes = [1, 5000, sp.TILE + 1, 69632, 3, 1 << 20, 2 * sp.TILE, 34816]
    cases = [_probe_args(("giant_run", "dup_heavy")[j % 2],
                         sizes[j % len(sizes)], j, cuda_device)
             for j in range(16)]
    sp.scan_probe_cuda(*cases[5])       # the scratch at its largest
    torch.cuda.synchronize()
    s = sp.scratch_of(cuda_device, torch.cuda.current_stream().cuda_stream, 1)
    tiles = s.tiles
    assert int(s.buf[0]) == 0
    outs = [sp.scan_probe_cuda(*cases[j % 16]) for j in range(200)]
    torch.cuda.synchronize()
    assert s.tiles == tiles and int(s.buf[0]) == 0
    for j, got in enumerate(outs):
        _same(got, sp.scan_probe_ref(*cases[j % 16]))


def test_scan_probe_grows_its_scratch_and_wraps_its_epoch(cuda_device):
    stream = torch.cuda.current_stream().cuda_stream
    sp._SCRATCH.pop((cuda_device.index, stream), None)
    small = _probe_args("giant_run", 3000, 1, cuda_device)
    large = _probe_args("giant_run", 1 << 20, 2, cuda_device)
    _same(sp.scan_probe_cuda(*small), sp.scan_probe_ref(*small))
    first = sp.scratch_of(cuda_device, stream, 1)
    assert first.tiles == sp.MIN_TILES
    got = sp.scan_probe_cuda(*large)   # more tiles: a new, zeroed scratch
    grown = sp.scratch_of(cuda_device, stream, 1)
    assert grown is not first and grown.tiles == (1 << 20) // sp.TILE
    _same(got, sp.scan_probe_ref(*large))
    grown.epoch = sp.EPOCH_MAX - 2    # the next calls cross the wrap
    outs = [sp.scan_probe_cuda(*(small, large)[j % 2]) for j in range(5)]
    assert grown.epoch == 3
    for j, got in enumerate(outs):
        _same(got, sp.scan_probe_ref(*(small, large)[j % 2]))


def test_scan_probe_refuses_graph_capture(cuda_device):
    """The epoch is kept on the host: a captured launch would replay with
    one frozen epoch, so the wrapper raises before it launches."""
    args = _probe_args("dup_heavy", 5000, 6, cuda_device)
    sp.scan_probe_cuda(*args)
    torch.cuda.synchronize()
    c0 = sp.counter.count
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="graph capture"):
        with torch.cuda.graph(graph):
            sp.scan_probe_cuda(*args)
    torch.cuda.synchronize()
    assert sp.counter.count == c0
    _same(sp.scan_probe_cuda(*args), sp.scan_probe_ref(*args))


def test_scan_probe_on_a_side_stream(cuda_device):
    """Each stream keeps a scratch of its own."""
    args = _probe_args("giant_run", 69632, 4, cuda_device)
    want = sp.scan_probe_ref(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [sp.scan_probe_cuda(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert (cuda_device.index, side.cuda_stream) in sp._SCRATCH
    for g in got:
        _same(g, want)


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


# ---------------------------------------------------------------------------
# attention kernels (tolerances of tests/test_kernels.py)
# ---------------------------------------------------------------------------

ATT_DTYPES = {"f32": (torch.float32, 2e-5), "bf16": (torch.bfloat16, 2e-2)}


def _randn(shape, dtype, dev, seed):
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(g).to(device=dev, dtype=dtype)


def _assert_close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if got.dtype == torch.bfloat16:
        # kernel and plain version both work in f32 and round once to bf16:
        # at most one ulp (2^-7 |out|) apart, plus f32 rounding
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -6,
                                   atol=1e-5)


@pytest.mark.parametrize("dt", list(ATT_DTYPES))
@pytest.mark.parametrize("b,h,kh,s,d,causal,window", [
    (1, 16, 8, 1024, 128, True, 0),      # the prefill shape, cut in B and S
    (1, 16, 8, 1000, 128, True, 0),      # ragged S
    (2, 4, 2, 1000, 64, False, 0),       # ragged S, no mask
    (1, 16, 8, 2048, 128, True, 1024),   # sliding window
    (2, 4, 1, 300, 32, False, 100),      # window without causality
    (1, 2, 2, 1, 32, True, 0)])          # one token
def test_flash_attention_kernel_matches_plain_on_card(cuda_device, dt, b, h,
                                                      kh, s, d, causal,
                                                      window):
    dtype, tol = ATT_DTYPES[dt]
    q = _randn((b, h, s, d), dtype, cuda_device, 1)
    k = _randn((b, kh, s, d), dtype, cuda_device, 2)
    v = _randn((b, kh, s, d), dtype, cuda_device, 3)
    c0 = fa.counter.count
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.counter.count == c0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, want, tol)
    # (B, S, H, D) storage read through transposed views
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    got_t = fa.flash_attention_cuda(qs, k, v, causal=causal, window=window)
    assert got_t.stride() == qs.stride()
    _assert_close(got_t, want, tol)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 63, 64, 127, 128, 129, 1000, 4096])
def test_flash_attention_bf16_tensor_cores_sweep(cuda_device, s, d):
    """The bf16 (wgmma + TMA) path at every tile edge of S (64-key tiles,
    128-query tiles) and every swizzle (D 32: 64 bytes, D 64: one 128-byte
    box, D 128: two), for g = 1, 2, 4 query heads per kv head, causal,
    non-causal and a causal 100-key window (which ends inside a tile),
    each also through (B, S, H, D) storage."""
    h = 4
    for kh in (4, 2, 1):
        q = _randn((1, h, s, d), torch.bfloat16, cuda_device, s + d + kh)
        k = _randn((1, kh, s, d), torch.bfloat16, cuda_device, s + d + 1)
        v = _randn((1, kh, s, d), torch.bfloat16, cuda_device, s + d + 2)
        for causal, window in ((True, 0), (False, 0), (True, 100)):
            want = fa.flash_attention_ref(q, k, v, causal=causal,
                                          window=window)
            got = fa.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window)
            torch.cuda.synchronize()
            _assert_close(got, want, 2e-2)
            tr = [x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v)]
            _assert_close(fa.flash_attention_cuda(*tr, causal=causal,
                                                  window=window), want, 2e-2)


def _pages(b, h, kh, d, page, np_, extra, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    npool = b * np_ + extra
    q = _randn((b, h, d), dtype, dev, seed)
    kp = _randn((npool, page, kh, d), dtype, dev, seed + 1)
    vp = _randn((npool, page, kh, d), dtype, dev, seed + 2)
    bt = rng.permutation(npool)[: b * np_].reshape(b, np_).astype(np.int32)
    lengths = rng.integers(1, np_ * page + 1, b).astype(np.int32)
    lengths[0] = np_ * page
    return q, kp, vp, bt, lengths


@pytest.mark.parametrize("dt", list(ATT_DTYPES))
@pytest.mark.parametrize("b,h,kh,d,page,np_", [
    (1, 16, 8, 128, 40, 1),        # the serve shape: one 40-row page
    (2, 16, 8, 128, 16, 256),      # decode_32k-like, cut to 4096 positions
    (3, 8, 2, 64, 24, 5),          # a page that is not a multiple of 64
    (2, 4, 2, 32, 5, 30),
    (3, 16, 1, 64, 16, 4)])
def test_paged_attention_kernel_matches_plain_on_card(cuda_device, dt, b, h,
                                                      kh, d, page, np_):
    dtype, tol = ATT_DTYPES[dt]
    tol = 3e-2 if dt == "bf16" else tol
    q, kp, vp, bt, ln = _pages(b, h, kh, d, page, np_, 7, dtype, cuda_device,
                               b + page)
    bt_t = torch.from_numpy(bt).to(cuda_device)
    ln_t = torch.from_numpy(ln).to(cuda_device)
    c0 = pa.counter.count
    got = pa.paged_attention_cuda(q, kp, vp, bt_t, ln_t)
    want = pa.paged_attention_ref(q, kp, vp, bt_t, ln_t)
    torch.cuda.synchronize()
    assert pa.counter.count == c0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, want, tol)
    # entries past ceil(length / page) may hold any id: the kernel never
    # reads them (the plain version, which reads every entry, gets the
    # valid table)
    junk = bt.copy()
    for i, n in enumerate(ln):
        junk[i, -(-int(n) // page):] = 2**30
    got_j = pa.paged_attention_cuda(q, kp, vp,
                                    torch.from_numpy(junk).to(cuda_device),
                                    ln_t)
    _assert_close(got_j, want, tol)
    # a length of 0 averages every row of the sequence's pages, like the
    # reference
    ln0 = ln_t.clone()
    ln0[-1] = 0
    _assert_close(pa.paged_attention_cuda(q, kp, vp, bt_t, ln0),
                  pa.paged_attention_ref(q, kp, vp, bt_t, ln0), tol)


@pytest.mark.parametrize("dt", list(ATT_DTYPES))
def test_paged_attention_serve_shape_every_length(cuda_device, dt):
    """The serve's decode calls: one 40-row page per slot under the identity
    table, lengths 1-40 (the mask inside the page), one slot per call and
    four slots in one."""
    dtype, tol = ATT_DTYPES[dt]
    tol = 3e-2 if dt == "bf16" else tol
    q = _randn((4, 16, 128), dtype, cuda_device, 11)
    kp = _randn((4, 40, 8, 128), dtype, cuda_device, 12)
    vp = _randn((4, 40, 8, 128), dtype, cuda_device, 13)
    ident = torch.arange(4, dtype=torch.int32, device=cuda_device)[:, None]
    for n in range(1, 41):
        ln = torch.full((1,), n, dtype=torch.int32, device=cuda_device)
        args = (q[:1], kp, vp, ident[:1], ln)
        _assert_close(pa.paged_attention_cuda(*args),
                      pa.paged_attention_ref(*args), tol)
    ln = torch.tensor([1, 17, 33, 40], dtype=torch.int32, device=cuda_device)
    _assert_close(pa.paged_attention_cuda(q, kp, vp, ident, ln),
                  pa.paged_attention_ref(q, kp, vp, ident, ln), tol)


@pytest.mark.parametrize("dt", list(ATT_DTYPES))
@pytest.mark.parametrize("page,np_", [(16, 80), (40, 32), (64, 20)])
def test_paged_attention_split_boundaries(cuda_device, dt, page, np_):
    """A 1280-row span (three splits of ``pa.SPLIT`` positions, so the
    merge runs) at lengths 0, 1, SPLIT - 1, SPLIT, SPLIT + 1 and the full
    span, through a permuted block table whose entries past
    ceil(length / page) hold 2^30 for the kernel (the plain version, which
    reads every entry, gets the valid table)."""
    dtype, tol = ATT_DTYPES[dt]
    tol = 3e-2 if dt == "bf16" else tol
    split = pa.SPLIT
    assert pa.split_plan(np_ * page) == (split, 3)
    lengths = np.array([0, 1, split - 1, split, split + 1, np_ * page],
                       np.int32)
    b = len(lengths)
    q, kp, vp, bt, _ = _pages(b, 16, 8, 128, page, np_, 5, dtype,
                              cuda_device, page)
    junk = bt.copy()
    for i, n in enumerate(lengths):
        if n > 0:
            junk[i, -(-int(n) // page):] = 2**30
    ln = torch.from_numpy(lengths).to(cuda_device)
    c0 = pa.counter.count
    got = pa.paged_attention_cuda(q, kp, vp,
                                  torch.from_numpy(junk).to(cuda_device), ln)
    want = pa.paged_attention_ref(q, kp, vp,
                                  torch.from_numpy(bt).to(cuda_device), ln)
    torch.cuda.synchronize()
    assert pa.counter.count == c0 + 1
    _assert_close(got, want, tol)


def test_paged_attention_launches_per_split_plan(cuda_device):
    """One kernel per call when the span fits one split (the serve's
    40-row slots), the split kernel and the merge when it does not."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(*args):
        pa.paged_attention_cuda(*args)
        torch.cuda.synchronize()
        for _ in range(3):   # a session that records no GPU event runs again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                pa.paged_attention_cuda(*args)
                torch.cuda.synchronize()
            names = sorted(e.key for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
            if names:
                return names
        return names

    for page, np_, want in ((40, 1, ["paged_split_kernel"]),
                            (16, 64, ["paged_merge_kernel",
                                      "paged_split_kernel"])):
        q, kp, vp, bt, ln = _pages(2, 16, 8, 128, page, np_, 0,
                                   torch.bfloat16, cuda_device, 3)
        names = kernels(q, kp, vp, torch.from_numpy(bt).to(cuda_device),
                        torch.from_numpy(ln).to(cuda_device))
        assert len(names) == len(want)
        assert all(w in n for n, w in zip(names, want)), names


def test_attention_wrappers_check_their_inputs_on_card(cuda_device):
    q = torch.zeros((1, 4, 64, 32), device=cuda_device)
    with pytest.raises(ValueError, match="expected one of"):
        fa.flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous last axis"):
        fa.flash_attention_cuda(q, q, q.transpose(2, 3))
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros((1, 4, 64, 48), device=cuda_device)
        fa.flash_attention_cuda(z, z, z)
    with pytest.raises(ValueError, match="cpu"):
        fa.flash_attention_cuda(q, q.cpu(), q)
    pad = torch.zeros((1, 4, 64, 33), device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_cuda(q, pad[..., 1:], q)
    qd = torch.zeros((2, 4, 32), device=cuda_device)
    pool = torch.zeros((4, 16, 2, 32), device=cuda_device)
    bt = torch.zeros((2, 2), dtype=torch.int32, device=cuda_device)
    ln = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention_cuda(qd, pool, pool, bt.long(), ln)
    with pytest.raises(ValueError, match="batch mismatch"):
        pa.paged_attention_cuda(qd, pool, pool, bt[:1], ln)
    pad = torch.zeros((4, 16, 2, 33), device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_attention_cuda(qd, pool, pad[..., 1:], bt, ln)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2.5-32b"])
def test_dense_model_on_card_matches_cpu(cuda_device, arch):
    """Smoke-size forward and decode on the card (through both attention
    kernels) against the same weights on the CPU (plain versions); bf16
    matmuls round differently in cuBLAS and on the CPU, hence the
    tolerance of tests/test_torch_models.py."""
    cfg = get_config(arch, smoke=True)
    mc, mg = Model(cfg, device="cpu"), Model(cfg, device=cuda_device)
    pc = mc.init(torch.Generator().manual_seed(0))
    pg = {k: ({n: t.to(cuda_device) for n, t in v.items()}
              if isinstance(v, dict) else v.to(cuda_device))
          for k, v in pc.items()}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)))
    f0, p0 = fa.counter.count, pa.counter.count
    lg, _ = mg.prefill(pg, toks.to(cuda_device))
    lc, _ = mc.prefill(pc, toks)
    _assert_close_model(lg.cpu(), lc)
    sg, sc = mg.init_decode_state(2, 8), mc.init_decode_state(2, 8)
    for t in range(8):
        lg, sg = mg.decode_step(pg, sg, toks[:, t:t + 1].to(cuda_device), t)
        lc, sc = mc.decode_step(pc, sc, toks[:, t:t + 1], t)
        _assert_close_model(lg.cpu(), lc)
    assert fa.counter.count - f0 == cfg.n_layers
    assert pa.counter.count - p0 == 8 * cfg.n_layers


def _assert_close_model(got, want):
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=6.25e-2)
    agree = (got.float().argmax(-1) == want.float().argmax(-1)).float().mean()
    assert float(agree) >= 0.9


def test_serve_on_card_gives_reference_stats(cuda_device):
    p0 = pa.counter.count
    stats = tserve.main(["--arch", "qwen3-0.6b", "--smoke", "--requests", "4",
                         "--max-new", "4"])
    assert stats == {"prefix_hits": 3, "prefix_misses": 5, "admitted": 4,
                     "completed": 4}
    assert pa.counter.count - p0 == 4 * (32 + 4 - 1) * 2


def test_model_attention_on_card_matches_cpu(cuda_device):
    q = _randn((2, 100, 4, 32), torch.bfloat16, cuda_device, 5)
    k = _randn((2, 100, 2, 32), torch.bfloat16, cuda_device, 6)
    got = tatt.gqa_attention(q, k, k, chunk=1024)
    want = tatt.gqa_attention(q.cpu(), k.cpu(), k.cpu(), chunk=1024)
    _assert_close(got.cpu(), want, 2e-2)
    got = tatt.decode_attention(q[:, :1], k, k, 37)
    want = tatt.decode_attention(q[:, :1].cpu(), k.cpu(), k.cpu(), 37)
    _assert_close(got.cpu(), want, 2e-2)


def test_sweeps_launch_one_kernel_per_call(cuda_device):
    """One kernel and nothing else (no memset, no second pass) per call,
    read from the profiler (CPU and CUDA activities, as chip_smoke.py
    profiles)."""
    from torch.profiler import ProfilerActivity, profile

    args = _probe_args("giant_run", 69632, 6, cuda_device)
    for fn, call_args, name in ((wcc.wc_combine_cuda, args[:1],
                                 "wc_combine_kernel"),
                                (sp.scan_probe_cuda, args,
                                 "scan_probe_kernel")):
        fn(*call_args)
        torch.cuda.synchronize()
        for _ in range(3):   # a session that records no GPU event runs again
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn(*call_args)
                torch.cuda.synchronize()
            events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            if events:
                break
        assert len(events) == 1 and name in events[0].name, [
            e.name for e in events]


# ---------------------------------------------------------------------------
# crash recovery and the RACE hash index: the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(SyncMode), ids=lambda m: m.name)
def test_crash_storm_on_card_equals_cpu(cuda_device, mode):
    """``crash_storm`` at ``benchmarks/recovery.py``'s FAST size through
    ``run_recovery`` (a quarter of 64 CNs fail-stop at window 8) and, at 3
    MN replicas with one dying at window 12, ``run_recovery_replicated``:
    the card, through the kernels, equals the CPU bit for bit."""
    from repro_torch.core import engine
    from repro_torch.core.credits import credit_init
    from repro_torch.core.types import EngineConfig
    from repro_torch.recovery import (mn_crash, run_recovery,
                                      run_recovery_replicated)
    from repro_torch.workloads.recovery import crash_storm
    w, b, nk, ncn = 16, 256, 512, 64
    ops, sched = crash_storm(w, b, nk, 64, ncn, seed=7, crash_window=8)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        stream = runner.make_stream(ops.kinds, ops.keys, ops.values,
                                    n_cns=ncn, alive=sched.alive, device=dev)
        runs = []
        for r in (1, 3):
            cfg = EngineConfig(n_slots=nk, heap_slots=nk + w * b, mode=mode,
                               n_replicas=r)
            st = engine.populate(cfg, engine.store_init(cfg, dev),
                                 np.arange(nk), np.arange(nk))
            c0 = wcc.counter.count
            if r == 1:
                run = run_recovery(cfg, st, credit_init(1024, dev), stream)
            else:
                run = run_recovery_replicated(cfg, st, credit_init(1024, dev),
                                              stream, mn_crash(w, 3, (2,), 12))
            assert wcc.counter.count - c0 == (w if dev.type == "cuda" else 0)
            runs.append(run)
        out[dev.type] = runs
    for card, cpu in zip(out["cuda"], out["cpu"]):
        for name in ("results", "io", "state", "credits"):
            a, c = getattr(card, name), getattr(cpu, name)
            for f in dataclasses.fields(a):
                assert torch.equal(getattr(a, f.name).cpu(),
                                   getattr(c, f.name)), (name, f.name)
        assert np.array_equal(card.valid, cpu.valid)
        assert card.recovery_io == cpu.recovery_io
    assert int(out["cuda"][0].io.repair_cas.sum()) > 0 or mode == SyncMode.OSYNC


@pytest.mark.parametrize("mode", [SyncMode.MCS, SyncMode.CIDER],
                         ids=lambda m: m.name)
def test_race_hash_batches_on_card_equal_cpu(cuda_device, mode):
    """Mixed batches (absent keys, same-key INSERT runs, overflow into a
    small table) through ``RaceHash.apply`` on the card and on the CPU:
    results, bill, overflow, index and store bit for bit; every apply
    launches ``wc_combine`` four times (reservation, its bucket ranks, the
    batch-local binding and the engine's window)."""
    from repro_torch.core.types import OpKind
    from repro_torch.stores import RaceHash
    rng = np.random.default_rng(11)
    kinds_all = [OpKind.SEARCH, OpKind.INSERT, OpKind.UPDATE, OpKind.DELETE]
    stores = {d: RaceHash.create(256, mode=mode, ways=4, device=d)
              for d in (cuda_device, "cpu")}
    for step in range(4):
        kinds = rng.choice(kinds_all, 512, p=(0.2, 0.5, 0.2, 0.1)).astype(
            np.int32)
        keys = rng.integers(0, 150 + 100 * step, 512).astype(np.int32)
        values = rng.integers(0, 10_000, 512).astype(np.int32)
        outs = {}
        for d, s in stores.items():
            c0 = wcc.counter.count
            s, res, io, ovf = s.apply(kinds, keys, values, n_cns=8)
            launched = wcc.counter.count - c0
            assert launched == (4 if d == cuda_device else 0)
            stores[d] = s
            outs[d] = (res, io, ovf, s)
        (rc, ic, oc, sc), (rp, ip, op, sp_) = outs[cuda_device], outs["cpu"]
        for a, c in ((rc, rp), (ic, ip), (sc.state, sp_.state),
                     (sc.credits, sp_.credits)):
            for f in dataclasses.fields(a):
                assert torch.equal(getattr(a, f.name).cpu(),
                                   getattr(c, f.name)), f.name
        assert torch.equal(oc.cpu(), op)
        assert torch.equal(sc.slot_keys.cpu(), sp_.slot_keys)
    assert bool(oc.any())
    scan = np.zeros(8, np.int32)
    scan[3] = OpKind.SCAN
    from repro_torch.core.types import UnsupportedOpError
    with pytest.raises(UnsupportedOpError):
        stores[cuda_device].apply(scan, np.arange(8), np.arange(8))


# ---------------------------------------------------------------------------
# the sharded store: a 4-way local mesh on the card against the CPU
# ---------------------------------------------------------------------------

def _sharded_case(dev, mode, w=8, b=512, nk=2048, ncn=16, n=4):
    """A 4-way store with hot keys, SCANs and a CN crash at window 5, and
    its stream, on ``dev``."""
    from repro_torch.core.types import EngineConfig, OpKind
    from repro_torch.dist import store as dstore
    rng = np.random.default_rng(5)
    kinds = rng.choice([OpKind.SEARCH, OpKind.INSERT, OpKind.UPDATE,
                        OpKind.DELETE, OpKind.SCAN], size=(w, b),
                       p=(0.25, 0.1, 0.4, 0.1, 0.15)).astype(np.int32)
    hot = rng.integers(0, nk, 8)
    keys = np.where(rng.random((w, b)) < 0.5, hot[rng.integers(0, 8, (w, b))],
                    rng.integers(0, nk, (w, b))).astype(np.int32)
    values = np.where(kinds == OpKind.SCAN, rng.integers(1, 12, (w, b)),
                      rng.integers(0, 1000, (w, b))).astype(np.int32)
    alive = np.ones((w, ncn), bool)
    alive[5:, :ncn // 4] = False
    cfg = EngineConfig(n_slots=nk, heap_slots=nk + w * b, mode=mode,
                       scan_max=8)
    stream = runner.make_stream(kinds, keys, values, n_cns=ncn, alive=alive,
                                device=dev)
    pk = np.arange(0, nk, 2)
    st = dstore.sharded_populate(cfg, n, dstore.sharded_store_init(cfg, n, dev),
                                 pk, pk)
    return cfg, stream, st


def _trees_equal(a, c, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(c, f.name)
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y), (what, f.name)


@pytest.mark.parametrize("mode", list(SyncMode), ids=lambda m: m.name)
def test_sharded_store_on_card_equals_cpu(cuda_device, mode):
    """``run_windows_sharded`` (per-shard, per-window bills) and
    ``run_windows_sharded_traced`` on a 4-way local mesh of the card equal
    the same runs on the CPU bit for bit; each shard's window launches
    ``wc_combine`` once for its plan, once for the probe plan and, in
    CIDER, once for the credit plane's full-window plan, and ``scan_probe``
    once."""
    from repro_torch.core.credits import credit_init
    from repro_torch.dist import store as dstore
    from repro_torch.launch.mesh import make_local_mesh
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        cfg, stream, st = _sharded_case(dev, mode)
        mesh = make_local_mesh(4, dev)
        c0, s0 = wcc.counter.count, sp.counter.count
        a = dstore.run_windows_sharded(cfg, mesh, st, credit_init(512, dev),
                                       stream, io_per_window=True,
                                       per_shard_io=True)
        per_call = 2 + (mode == SyncMode.CIDER)
        w = stream.shape[0]
        on_card = dev.type == "cuda"
        assert wcc.counter.count - c0 == (w * 4 * per_call if on_card else 0)
        assert sp.counter.count - s0 == (w * 4 if on_card else 0)
        b = dstore.run_windows_sharded_traced(cfg, mesh, st,
                                              credit_init(512, dev), stream)
        out[dev.type] = (a, b)
    for card, cpu in zip(out["cuda"], out["cpu"]):
        for i, what in enumerate(("state", "credits", "results", "io")):
            _trees_equal(card[i], cpu[i], what)
    assert torch.equal(out["cuda"][1][4].cpu(), out["cpu"][1][4])
    assert int(out["cpu"][0][2].rows.sum()) > 0


@pytest.mark.parametrize("mode", [SyncMode.MCS, SyncMode.CIDER],
                         ids=lambda m: m.name)
def test_shard_failover_on_card_equals_cpu(cuda_device, mode):
    """``run_recovery_sharded``: 4 shards, survivors (0, 2) from the crash
    window, on the card and on the CPU, bit for bit, recovery bill
    included."""
    from repro_torch.core.credits import credit_init
    from repro_torch.recovery import FailoverEvent, run_recovery_sharded
    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        cfg, stream, st = _sharded_case(dev, mode)
        runs[dev.type] = run_recovery_sharded(
            cfg, 4, st, credit_init(512, dev), stream,
            failovers=[FailoverEvent(5, (0, 2))])
    card, cpu = runs["cuda"], runs["cpu"]
    for name in ("results", "io", "state", "credits"):
        _trees_equal(getattr(card, name), getattr(cpu, name), name)
    assert card.recovery_io == cpu.recovery_io
    assert card.n_shards == cpu.n_shards == 2


# ---------------------------------------------------------------------------
# the protocol simulator: ticks replayed from CUDA graphs
# ---------------------------------------------------------------------------

def _sim_case(dev, **over):
    from repro_torch.core import sim
    from repro_torch.core.simnet import SimParams
    p = SimParams(**{**dict(n_lanes=512, max_ops=256, ticks=300), **over})
    streams = sim.make_streams(p, WORKLOADS["write-intensive"], 1_000_000,
                               seed=3, device=dev)
    return p, streams


def _sim_states_equal(a, b):
    from repro_torch import interop
    x, y = interop.sim_state_to_numpy(a), interop.sim_state_to_numpy(b)
    for name in x:
        if name == "net":
            for g in x["net"]:
                np.testing.assert_array_equal(x["net"][g], y["net"][g],
                                              err_msg=f"net.{g}")
        else:
            np.testing.assert_array_equal(x[name], y[name], err_msg=name)


@pytest.mark.parametrize("mode", list(SyncMode), ids=lambda m: m.name)
def test_sim_graph_replay_equals_eager_on_card(cuda_device, mode):
    """300 ticks (4 replays of a 64-tick graph and one 44-tick graph) equal
    300 eager ticks on the card and on the CPU, every ``SimState`` field;
    each graph captures two ``wc_combine`` launches a tick."""
    from repro_torch.core import sim
    p, st = _sim_case(cuda_device)
    s0 = sim.initial_state(p, st, 400)
    record = []
    graphed = sim.advance(p, mode, st, s0, 0, p.ticks, record=record)
    eager = sim.advance(p, mode, st, s0, 0, p.ticks, graph=False)
    _sim_states_equal(graphed, eager)
    assert [(g.n, g.replays) for g in record] == [(64, 4), (44, 1)]
    assert [g.captured["wc_combine"] for g in record] == [128, 88]
    p_cpu, st_cpu = _sim_case("cpu")
    cpu = sim.advance(p_cpu, mode, st_cpu, sim.initial_state(p_cpu, st_cpu,
                                                             400),
                      0, p.ticks)
    _sim_states_equal(graphed, cpu)


def test_sim_tick_count_not_a_multiple_of_the_graph(cuda_device):
    """400 ticks = 6 replays of 64 + one graph of 16, crash and repair on:
    ``run_sim`` on the card equals it on the CPU."""
    from repro_torch.core import sim
    over = dict(n_lanes=64, max_ops=128, ticks=400, lanes_per_cn=1,
                local_wc=False, fail_lanes=(3, 5, 9), fail_tick=100,
                max_wait=64)
    results = {}
    for dev in (cuda_device, torch.device("cpu")):
        from repro_torch.core.simnet import SimParams
        p = SimParams(**over)
        st = sim.make_streams(p, WORKLOADS["write-only"], 1, device=dev)
        record = []
        results[dev.type] = sim.run_sim(p, SyncMode.MCS, st, 16,
                                        record=record)
        if dev.type == "cuda":
            assert [(g.n, g.replays) for g in record] == [(64, 6), (16, 1)]
    assert dataclasses.asdict(results["cuda"]) == \
        dataclasses.asdict(results["cpu"])
    assert results["cpu"].deadlocks >= 3


def test_sim_replay_makes_no_host_sync(cuda_device):
    """Graph replays under ``set_sync_debug_mode("error")`` (which raises on
    a synchronizing call) advance the state like eager ticks."""
    from repro_torch.core import sim
    p, st = _sim_case(cuda_device)
    s0 = sim.initial_state(p, st, 512)
    state = sim._state_map(torch.clone, s0)
    t = torch.zeros((), dtype=torch.int32, device=cuda_device)
    g = sim.TickGraph(p, SyncMode.CIDER, st, state, t, 32)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            g.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(t) == 96
    _sim_states_equal(state, sim.advance(p, SyncMode.CIDER, st, s0, 0, 96,
                                         graph=False))


def test_sim_race_check_conformance_on_card(cuda_device):
    from repro_torch.analysis import race_check
    notes, record = [], []
    assert race_check._sim_conformance(notes, device=cuda_device,
                                       record=record) == []
    assert "on cuda" in notes[0]
    # two runs of 400 ticks: 6 replays of 64 ticks and one graph of 16
    assert [(g.n, g.replays) for g in record] == [(64, 6), (16, 1)] * 2
