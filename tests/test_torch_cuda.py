"""The port on the GPU: the hand-written CUDA kernels against their plain
PyTorch versions, the engine path through the kernels against the same
path through the plain versions, and the serving slice (attention kernels,
the dense model, the serve loop) on the card against the CPU.  Every test
here is marked ``cuda`` and skips without a GPU.  This file imports no JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import contextlib
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
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
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
@pytest.mark.parametrize("n", [1, 6, 1000, 4096, 12288, 34816, 69632,
                               1 << 20])
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


@pytest.mark.parametrize("d", [32, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("s", [1, 63, 64, 127, 128, 129, 1000, 4096])
def test_flash_attention_bf16_tensor_cores_sweep(cuda_device, s, d):
    """The bf16 (wgmma + TMA) path at every tile edge of S (64-key tiles,
    128-query tiles) and every swizzle (D 32: 64 bytes, D 64: one 128-byte
    box, D 128: two; D 80 and 96: one 128-byte box and a tail box of 32 or
    64 bytes with its own swizzle; D 112: two 128-byte boxes, the second
    zero-filled past the row), for g = 1, 2, 4 query heads per kv
    head, causal, non-causal and a causal 100-key window (which ends inside
    a tile), each also through (B, S, H, D) storage."""
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
@pytest.mark.parametrize("b,h,kh,d,page,np_", [
    (1, 16, 8, 128, 40, 1),        # one split: the single-block path
    (2, 16, 8, 128, 16, 256),      # 4096 rows: 8 splits and the merge
    (3, 8, 2, 64, 24, 5)])
def test_paged_attention_lse_on_card(cuda_device, dt, b, h, kh, d, page,
                                     np_):
    """``return_lse`` (a part of a split sequence): the output in f32,
    within f32 rounding of the plain version's and rounding to the bits of
    the output without it, and each head's log-sum-exp within f32 rounding
    of the plain version's, in both the single-block path and the merge;
    a length 0 reads nothing (output 0, lse -inf)."""
    dtype, _ = ATT_DTYPES[dt]
    q, kp, vp, bt, ln = _pages(b, h, kh, d, page, np_, 7, dtype, cuda_device,
                               b + page)
    bt_t = torch.from_numpy(bt).to(cuda_device)
    ln_t = torch.from_numpy(ln).to(cuda_device)
    ln_t[-1] = 0
    c0 = pa.counter.count
    out, lse = pa.paged_attention_cuda(q, kp, vp, bt_t, ln_t,
                                       return_lse=True)
    assert pa.counter.count == c0 + 1
    want, want_lse = pa.paged_attention_ref(q, kp, vp, bt_t, ln_t,
                                            return_lse=True)
    assert out.dtype == torch.float32 and out.shape == (b, h, d)
    assert lse.dtype == torch.float32 and lse.shape == (b, h)
    assert torch.equal(out[:-1].to(dtype),
                       pa.paged_attention_cuda(q, kp, vp, bt_t, ln_t)[:-1])
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse[:-1], want_lse[:-1], rtol=1e-5, atol=1e-4)
    assert not bool(out[-1].any()) and bool((lse[-1] == -torch.inf).all())


@pytest.mark.parametrize("dt", list(ATT_DTYPES))
@pytest.mark.parametrize("n", [2, 4, 8])
def test_decode_attention_spmd_on_card(cuda_device, dt, n):
    """The split-sequence decode on the card (one ``paged_attention``
    launch over B x n parts, merged by their log-sum-exps) against the
    unsplit kernel and the plain decode, at lengths on and around the
    parts' boundaries and with a (B,) length tensor, within the attention
    tolerance and, in bf16, two ulps (each part's f32 output is merged in
    f32 and rounded once, as the unsplit kernel rounds once)."""
    from repro_torch.dist.decode_attn import decode_attention_spmd
    from repro_torch.launch.mesh import make_local_mesh
    dtype, tol = ATT_DTYPES[dt]
    b, h, kh, d, smax = 3, 16, 8, 128, 1024
    q = _randn((b, 1, h, d), dtype, cuda_device, 1)
    k = _randn((b, smax, kh, d), dtype, cuda_device, 2)
    v = _randn((b, smax, kh, d), dtype, cuda_device, 3)
    mesh = make_local_mesh(1, cuda_device, model=n)
    part = smax // n
    for length in (0, 1, part, part + 1, smax,
                   torch.tensor([0, part + 1, smax - 5], dtype=torch.int32,
                                device=cuda_device)):
        c0 = pa.counter.count
        got = decode_attention_spmd(mesh, q, k, v, length)
        assert pa.counter.count == c0 + 1
        assert got.dtype == dtype and got.shape == (b, 1, h, d)
        for want in (tatt.decode_attention(q, k, v, length),
                     tatt.decode_attention(q.cpu(), k.cpu(), v.cpu(),
                                           length.cpu() if isinstance(
                                               length, torch.Tensor)
                                           else length)):
            _assert_close(got.cpu(), want.cpu(), tol)


@pytest.mark.parametrize("dt", list(ATT_DTYPES))
def test_combined_embed_grad_on_card(cuda_device, dt):
    """``combined_embed_grad``'s run flags from the ``wc_combine`` kernel:
    ``hids`` and ``uniq`` equal to the CPU's bit for bit, ``rows`` within
    f32 summation order (the segment sum adds by atomics on the card), and
    the SGD-applied table within a bf16 ulp of the dense gradient's."""
    from repro_torch.dist import embed_grad as eg
    from repro_torch.workloads import zipf
    dtype = ATT_DTYPES[dt][0]
    vocab, dim, t = 4096, 64, 8192
    gen = torch.Generator().manual_seed(0)
    cdf = torch.from_numpy(zipf.zipf_cdf_table(vocab, 0.99))
    ids = zipf.sample_zipf_torch(gen, (t,), cdf, vocab)
    g = _randn((t, dim), dtype, "cpu", 4)
    c0 = wcc.counter.count
    got = eg.combined_embed_grad(ids.to(cuda_device), g.to(cuda_device))
    assert wcc.counter.count == c0 + 1
    want = eg.combined_embed_grad(ids, g)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2].cpu(), want[2])
    torch.testing.assert_close(got[1].cpu().float(), want[1].float(),
                               rtol=2.0 ** -7 if dt == "bf16" else 1e-5,
                               atol=1e-4)
    table = _randn((vocab, dim), dtype, cuda_device, 5)
    sparse = eg.apply_sparse_grad(table.clone(), *got, lr=0.1)
    dense = table - 0.1 * eg.dense_embed_grad(
        ids.to(cuda_device), g.to(cuda_device).float(), vocab).to(dtype)
    torch.testing.assert_close(sparse.float(), dense.float(),
                               rtol=2.0 ** -6 if dt == "bf16" else 1e-5,
                               atol=1e-3)


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


@pytest.mark.parametrize("dt", list(ATT_DTYPES))
@pytest.mark.parametrize("b,h,kh,s,d,causal,window", [
    (2, 16, 16, 1024, 80, False, 0),     # hubert-xlarge
    (1, 32, 32, 640, 96, True, 0),       # phi-3-vision: 576 patches + 64
    (1, 16, 1, 4096, 256, True, 2048),   # recurrentgemma-9b
    (1, 16, 16, 2048, 128, True, 0),     # deepseek-moe-16b: no grouping
    (1, 64, 8, 2048, 112, True, 0),      # kimi-k2-1t-a32b
    (2, 4, 2, 129, 80, True, 0),         # ragged S at every new head dim
    (1, 4, 1, 300, 96, False, 100),
    (1, 4, 4, 65, 256, True, 0),
    (2, 8, 1, 129, 112, False, 0)])
def test_flash_attention_new_head_dims_match_plain_on_card(cuda_device, dt, b,
                                                           h, kh, s, d,
                                                           causal, window):
    """Head dims 80, 96, 112 and 256 (in bf16 the tensor cores, at D 256
    in the two-stage geometry; f32 on the CUDA cores) at the shapes and
    masks of the models that use them, and ragged; and deepseek-moe-16b's
    D 128 prefill, whose kv heads are its query heads."""
    dtype, tol = ATT_DTYPES[dt]
    q = _randn((b, h, s, d), dtype, cuda_device, d + 1)
    k = _randn((b, kh, s, d), dtype, cuda_device, d + 2)
    v = _randn((b, kh, s, d), dtype, cuda_device, d + 3)
    c0 = fa.counter.by_size.get(d, 0)
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.counter.by_size[d] == c0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, want, tol)
    tr = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    _assert_close(fa.flash_attention_cuda(*tr, causal=causal, window=window),
                  want, tol)


@pytest.mark.parametrize("dt", list(ATT_DTYPES))
@pytest.mark.parametrize("h,kh,d", [(32, 32, 96), (16, 1, 256),
                                    (16, 16, 128), (64, 8, 112),
                                    (8, 1, 112)])
def test_paged_attention_new_head_dims_match_plain_on_card(cuda_device, dt, h,
                                                           kh, d):
    """Head dims 96 (phi-3-vision), 112 (kimi-k2-1t-a32b; a bf16 row of 14
    chunks, which the 4 lanes of a position share 4, 4, 3 and 3) and 256
    (recurrentgemma-9b, 16 query heads on one kv head), and
    deepseek-moe-16b's D 128 with one query head a kv head, at the serve
    shape, every length 1-40, and over a
    permuted table whose span takes three splits and the merge."""
    dtype, tol = ATT_DTYPES[dt]
    tol = 3e-2 if dt == "bf16" else tol
    q = _randn((1, h, d), dtype, cuda_device, d)
    kp = _randn((1, 40, kh, d), dtype, cuda_device, d + 1)
    vp = _randn((1, 40, kh, d), dtype, cuda_device, d + 2)
    ident = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
    for n in range(1, 41):
        ln = torch.full((1,), n, dtype=torch.int32, device=cuda_device)
        _assert_close(pa.paged_attention_cuda(q, kp, vp, ident, ln),
                      pa.paged_attention_ref(q, kp, vp, ident, ln), tol)
    q, kp, vp, bt, ln = _pages(3, h, kh, d, 16, 80, 5, dtype, cuda_device, d)
    args = (q, kp, vp, torch.from_numpy(bt).to(cuda_device),
            torch.from_numpy(ln).to(cuda_device))
    assert pa.split_plan(80 * 16)[1] == 3
    c0 = pa.counter.by_size.get(d, 0)
    got = pa.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    assert pa.counter.by_size[d] == c0 + 1
    _assert_close(got, pa.paged_attention_ref(*args), tol)


@pytest.mark.parametrize("dt", list(ATT_DTYPES))
@pytest.mark.parametrize("span,lengths", [
    (40, range(1, 41)),                          # the serve's 40-row slot
    (2048, (1, 511, 512, 513, 1500, 2047, 2048))])  # the full ring
@pytest.mark.parametrize("n_hgroups", [None, 1, 4])
def test_paged_attention_mqa_head_groups_on_card(cuda_device, dt, span,
                                                 lengths, n_hgroups):
    """recurrentgemma-9b's decode attention (H 16 on one kv head, D 256,
    B 1) over its serve slot and its full 2,048-row ring, with the query
    heads split as the host plans (``head_group_plan``: 16 groups), in 4
    groups and in none (through the launcher's private ``_launch``): every
    length against the plain version, and every launch ran the grid asked
    for, as the launcher reports it (``counter_plan``)."""
    dtype, tol = ATT_DTYPES[dt]
    q = _randn((1, 16, 256), dtype, cuda_device, span)
    kp = _randn((1, span, 1, 256), dtype, cuda_device, span + 1)
    vp = _randn((1, span, 1, 256), dtype, cuda_device, span + 2)
    ident = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
    n_split = pa.split_plan(span)[1]
    groups = n_hgroups or pa.head_group_plan(
        1, 1, 16, span, pa.fill_blocks(cuda_device))
    assert n_hgroups is not None or groups == 16
    pa.counter_plan.reset()
    for n in lengths:
        ln = torch.full((1,), n, dtype=torch.int32, device=cuda_device)
        got = pa._launch(q, kp, vp, ident, ln, False, n_hgroups)
        _assert_close(got, pa.paged_attention_ref(q, kp, vp, ident, ln), tol)
    assert pa.counter_plan.by_size == {
        pa.Plan(groups, n_split, groups * n_split): len(lengths)}
    out, lse = pa._launch(q, kp, vp, ident, ln, True, n_hgroups)
    want, want_lse = pa.paged_attention_ref(q, kp, vp, ident, ln,
                                            return_lse=True)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)


def test_attention_wrappers_check_their_inputs_on_card(cuda_device):
    """The wrappers refuse what no kernel takes (a dtype, a strided last
    axis, a tensor off the card, a block table's dtype or batch, a head
    grouping), and return the plain version's result at a head dim past
    256 (D 264), at one whose rows are not whole 16-byte chunks (D 20 in
    bf16) and on views whose rows are off 16-byte boundaries: flash on
    its plan's padded copies, paged loading the rows itself."""
    q = torch.zeros((1, 4, 64, 32), device=cuda_device)
    with pytest.raises(ValueError, match="expected one of"):
        fa.flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous last axis"):
        fa.flash_attention_cuda(q, q, q.transpose(2, 3))
    with pytest.raises(ValueError, match="cpu"):
        fa.flash_attention_cuda(q, q.cpu(), q)
    gen = torch.Generator().manual_seed(0)
    for shape, dtype, sl, plan in (
            ((1, 4, 64, 264), torch.float32, slice(None), (264, 256, 2, False)),
            ((1, 4, 64, 24), torch.bfloat16, slice(0, 20), (20, 32, 1, True)),
            ((1, 4, 64, 33), torch.float32, slice(1, None), (32, 32, 1, True))):
        z = torch.randn(shape, generator=gen).to(dtype).to(cuda_device)[..., sl]
        i0 = dict(fa.counter_instance.by_size)
        got = fa.flash_attention_cuda(z, z, z)
        assert _new_instances(fa.counter_instance, i0) == {plan: 1}
        _assert_close(got, fa.flash_attention_ref(z, z, z),
                      ATT_DTYPES["bf16" if dtype == torch.bfloat16
                                 else "f32"][1])
    qd = torch.zeros((2, 4, 32), device=cuda_device)
    pool = torch.zeros((4, 16, 2, 32), device=cuda_device)
    bt = torch.zeros((2, 2), dtype=torch.int32, device=cuda_device)
    ln = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention_cuda(qd, pool, pool, bt.long(), ln)
    with pytest.raises(ValueError, match="batch mismatch"):
        pa.paged_attention_cuda(qd, pool, pool, bt[:1], ln)
    with pytest.raises(ValueError, match="head groups"):
        pa._launch(qd, pool, pool, bt, ln, False, 3)
    for d, sl in ((32, slice(1, None)), (264, slice(None)), (20, slice(None))):
        width = d + 1 if sl.start else d
        qd = torch.randn((2, 4, d), generator=gen).to(cuda_device)
        big = torch.randn((4, 16, 2, width), generator=gen).to(
            cuda_device)[..., sl]
        got = pa.paged_attention_cuda(qd, big, big, bt, ln)
        _assert_close(got, pa.paged_attention_ref(qd, big, big, bt, ln),
                      ATT_DTYPES["f32"][1])


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


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "hubert-xlarge",
                                  "phi-3-vision-4.2b"])
def test_other_families_on_card_match_cpu(cuda_device, arch):
    """Each other family's smoke config: a forward (with its frontend's
    stub features) and four decode steps on the card against the same
    weights on the CPU, the MoE routing of the CPU run replayed on the
    card (``moe.pinned_routing``: a near-tie flips under the card's other
    rounding), and the card's own choices differing from the CPU's in at
    most 10 % of them (1.2-4 % at full width).  The hybrid runs at head dim 32: its smoke config's 16 is not a
    head dim of the kernels.  Tolerance: the model tests' (the hybrid's
    rtol 1e-1 / atol 1.5e-1; tests/test_torch_models.py says why)."""
    cfg = get_config(arch, smoke=True)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, head_dim=32)
    rtol, atol = (1e-1, 1.5e-1) if cfg.family == "hybrid" else (2e-2, 6.25e-2)
    mc, mg = Model(cfg, device="cpu"), Model(cfg, device=cuda_device)
    pc = mc.init(torch.Generator().manual_seed(0))
    pg = _to(pc, cuda_device)
    rng = np.random.default_rng(1)
    n_text = 0 if cfg.family == "encoder" else 64 - cfg.n_patches
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, n_text)))
    feats = None
    if cfg.frontend:
        n_front = 64 if cfg.frontend == "audio" else cfg.n_patches
        feats = torch.from_numpy(rng.standard_normal(
            (2, n_front, cfg.frontend_dim)).astype(np.float32)).bfloat16()
    moe = cfg.family == "moe"
    f0, p0 = dict(fa.counter.by_size), dict(pa.counter.by_size)
    rec = []
    with tmoe.pinned_routing(record=rec) if moe else contextlib.nullcontext():
        lc, _, _ = ttfm.forward(cfg, pc, toks, feats)
    flips = [0, 0]
    with (tmoe.pinned_routing(replay=rec) if moe
          else contextlib.nullcontext()) as f:
        lg, _, _ = ttfm.forward(cfg, pg, toks.to(cuda_device),
                                None if feats is None else
                                feats.to(cuda_device))
    if moe:
        flips = list(f)
    torch.testing.assert_close(lg.cpu().float(), lc.float(), rtol=rtol,
                               atol=atol)
    n_attn = {"ssm": 0, "hybrid": cfg.n_layers // 3}.get(cfg.family,
                                                         cfg.n_layers)
    assert fa.counter.by_size.get(cfg.hd, 0) - f0.get(cfg.hd, 0) == n_attn
    if not cfg.has_decode:
        return
    sc, sg = mc.init_decode_state(2, 8), mg.init_decode_state(2, 8)
    for t in range(4):
        tok = toks[:, t:t + 1]
        rec = []
        with tmoe.pinned_routing(record=rec) if moe else contextlib.nullcontext():
            lc, sc = mc.decode_step(pc, sc, tok, t)
        with (tmoe.pinned_routing(replay=rec) if moe
              else contextlib.nullcontext()) as f:
            lg, sg = mg.decode_step(pg, sg, tok.to(cuda_device), t)
        if moe:
            flips = [flips[0] + f[0], flips[1] + f[1]]
        torch.testing.assert_close(lg.cpu().float(), lc.float(), rtol=rtol,
                                   atol=atol)
    if moe:
        assert 0 < flips[1] and flips[0] <= 0.1 * flips[1], flips
    assert pa.counter.by_size.get(cfg.hd, 0) - p0.get(cfg.hd, 0) == 4 * n_attn
    for name in sc:
        torch.testing.assert_close(sg[name].cpu().float(), sc[name].float(),
                                   rtol=rtol, atol=atol)


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


# The profiler sessions of test_sweeps_launch_one_kernel_per_call, run in
# a process of their own: in a process that has already profiled (the
# file's earlier cases, under chip_smoke-style sessions) and launched many
# kernels, a new session may record no GPU event at all; a fresh process
# has profiled nothing.  Prints, as JSON, each sweep's GPU event names.
_SWEEP_PROFILE = """
import json, sys
sys.path[:0] = sys.argv[1:3]
import torch
from torch.profiler import ProfilerActivity, profile
import test_torch_cuda as t
dev = torch.device("cuda", 0)
args = t._probe_args("giant_run", 69632, 6, dev)
names = {}
for fn, call_args, name in ((t.wcc.wc_combine_cuda, args[:1],
                             "wc_combine_kernel"),
                            (t.sp.scan_probe_cuda, args,
                             "scan_probe_kernel")):
    fn(*call_args)
    torch.cuda.synchronize()
    for _ in range(3):   # a session that records no GPU event runs again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*call_args)
            torch.cuda.synchronize()
        names[name] = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
        if names[name]:
            break
print(json.dumps(names))
"""


def test_sweeps_launch_one_kernel_per_call(cuda_device):
    """One kernel and nothing else (no memset, no second pass) per call,
    read from the profiler (CPU and CUDA activities, as chip_smoke.py
    profiles), in a fresh process (``_SWEEP_PROFILE``), so that the
    profiler sessions of the cases before this one cannot leave it
    recording nothing."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    here = Path(__file__).resolve().parent
    run = subprocess.run(
        [sys.executable, "-c", _SWEEP_PROFILE, str(here.parent / "src"),
         str(here)], capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    names = json.loads(run.stdout.strip().splitlines()[-1])
    for name in ("wc_combine_kernel", "scan_probe_kernel"):
        events = names[name]
        assert len(events) == 1 and name in events[0], (name, events)


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


# the backward kernel against its plain version, both fed the kernel
# forward's output and lse: (rtol, atol as a share of the largest |want|,
# or of 1 where that is smaller: dS = P (dP - delta) cancels, to 0 at S = 1,
# and the residue is f32 rounding of the unit-scale inputs' products).
# f32: the two sum over up to S products in other orders; bf16: both work
# in f32 from the same bf16 inputs and round once, so at most an ulp or two
# apart (2^-7 relative each) beside f32 rounding
BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -6, 1e-4)}


def assert_grads_close(got, want, dtype, what=""):
    rtol, atol = BWD_TOL[dtype]
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape, (what, name)
        assert bool(torch.isfinite(g).all()), (what, name)
        scale = max(float(w.float().abs().max()), 1.0)
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol * scale, msg=f"{what} {name}")


@pytest.mark.parametrize("dt", list(ATT_DTYPES))
@pytest.mark.parametrize("b,h,kh,s,d,causal,window", [
    (1, 16, 8, 1024, 128, True, 0),      # the training shape, cut in B, S
    (1, 16, 8, 1000, 128, True, 0),      # ragged S
    (2, 4, 2, 1000, 64, False, 0),       # ragged S, no mask
    (1, 16, 8, 2048, 128, True, 1024),   # sliding window
    (2, 4, 1, 300, 32, False, 100),      # window without causality
    (1, 4, 4, 200, 80, False, 0),        # hubert's head dim
    (1, 8, 8, 130, 96, True, 0),         # phi-3-vision's
    (1, 4, 1, 300, 256, True, 64),       # recurrentgemma's, windowed MQA
    (1, 8, 1, 300, 112, True, 0),        # kimi-k2-1t-a32b's, g 8, ragged
    (1, 2, 2, 1, 32, True, 0)])          # one token
def test_flash_attention_bwd_matches_plain_on_card(cuda_device, dt, b, h, kh,
                                                   s, d, causal, window):
    _check_bwd_on_card(cuda_device, ATT_DTYPES[dt][0], b, h, kh, s, d,
                       causal, window)


def _check_bwd_on_card(cuda_device, dtype, b, h, kh, s, d, causal, window):
    """The backward kernel against its plain version (``BWD_TOL``), through
    dense tensors and through transposed views, and the same bits again."""
    q = _randn((b, h, s, d), dtype, cuda_device, 1)
    k = _randn((b, kh, s, d), dtype, cuda_device, 2)
    v = _randn((b, kh, s, d), dtype, cuda_device, 3)
    do = _randn((b, h, s, d), dtype, cuda_device, 4)
    kw = dict(causal=causal, window=window)
    _, lse, out = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    _, lse_ref, _ = fa.flash_attention_ref(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    c0 = fa.counter_bwd.count
    got = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert fa.counter_bwd.count == c0 + 1
    assert_grads_close(got, want, dtype, f"{dtype} {b, h, kh, s, d}")
    # (B, S, H, D) storage read through transposed views, as the model does
    tr = [x.transpose(1, 2).contiguous().transpose(1, 2)
          for x in (q, k, v, out, do)]
    assert_grads_close(fa.flash_attention_bwd_cuda(*tr, lse, **kw), want,
                       dtype, "views")
    again = fa.flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    for x, y in zip(got, again):       # no atomics: the same bits
        assert torch.equal(x, y)


@pytest.mark.parametrize("b,h,kh,s,d,causal,window", [
    (2, 16, 8, 4096, 128, True, 0),      # the training shape, in full
    (1, 4, 4, 130, 128, False, 0),       # a 128-row tile of 2 rows (g = 1)
    (2, 8, 2, 190, 64, True, 48),        # of 62 rows, a window (g = 4)
    (2, 16, 16, 1024, 80, False, 0),     # hubert-xlarge's training shape
    (1, 32, 32, 640, 96, True, 0),       # phi-3-vision's
    (1, 4, 4, 130, 96, False, 0),        # D 96: a tile of 2 rows
    (2, 8, 2, 190, 80, True, 48),        # D 80: of 62 rows, a window, GQA
    (1, 16, 1, 4096, 256, True, 2048),   # recurrentgemma-9b's, 4 groups
    (1, 4, 1, 130, 256, True, 64),       # D 256: a 64-row tile of 2 rows
    (2, 8, 4, 1100, 256, True, 0),       # D 256, GQA, 144 blocks: one group
    (1, 64, 8, 4096, 112, True, 0),      # kimi-k2-1t-a32b's (D 112)
    (1, 8, 2, 190, 112, True, 48)])      # D 112: of 62 rows, a window
def test_flash_attention_bwd_tensor_cores_match_plain_on_card(
        cuda_device, b, h, kh, s, d, causal, window):
    """bf16 at the shapes the tensor-core design's tiles meet: the training
    shapes (D 128; hubert-xlarge's D 80 and phi-3-vision's D 96, a row a
    64-column box and a tail box; recurrentgemma-9b's D 256, 64-row blocks
    whose warpgroups split each tile pair, its dK/dV pass over four head
    groups), and an S whose last tile (128 rows, 64 at D 256) is partly
    filled, so that a consumer warpgroup of the last tile has fewer than
    64 rows or none; at D 256 the plan the launcher reports is
    ``bwd_head_groups``'."""
    p0 = dict(fa.counter_bwd_plan.by_size)
    _check_bwd_on_card(cuda_device, torch.bfloat16, b, h, kh, s, d, causal,
                       window)
    plans = {p for p, n in fa.counter_bwd_plan.by_size.items()
             if n > p0.get(p, 0)}
    groups = (fa.bwd_head_groups(b, kh, h // kh, s,
                                 pa.fill_blocks(cuda_device))
              if d in fa.BWD_GROUPED_DIMS else 1)
    own = 64 if d in fa.BWD_GROUPED_DIMS else 128
    assert plans == {fa.BwdPlan(groups, -(-s // own) * groups * kh * b)}


@pytest.mark.parametrize("d", [128, 80, 96, 112, 256])
def test_flash_attention_lse_f32_output_on_card(cuda_device, d):
    """With ``return_lse`` the forward also returns its f32 output, which
    rounds to its bf16 output bit for bit and stays within the plain f32
    output's rounding, in both geometries of the tensor-core design (D 80,
    96, 112 and 128; D 256); in f32 it is the output itself."""
    q = _randn((1, 4, 300, d), torch.bfloat16, cuda_device, 1)
    k, v = (_randn((1, 2, 300, d), torch.bfloat16, cuda_device, i)
            for i in (2, 3))
    out, lse, out32 = fa.flash_attention_cuda(q, k, v, return_lse=True)
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v))
    assert out32.dtype == torch.float32 and out32.stride() == out.stride()
    assert torch.equal(out32.to(torch.bfloat16), out)
    _, lse_ref, want = fa.flash_attention_ref(q, k, v, return_lse=True)
    torch.testing.assert_close(out32, want, rtol=2.0 ** -8, atol=1e-4)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    o, _, o32 = fa.flash_attention_cuda(q32, k32, v32, return_lse=True)
    assert o32 is o


# head dims between the compiled instances, each run on the next one with
# zero-filled columns: recurrentgemma-9b's smoke D 16 (instance 32), 48
# (64), 72 (80), 136 (256: a whole 64-column box past the row) and 200
# (256); paged also D 80 (96)
ANY_D = [16, 48, 72, 136, 200, 6, 20, 264, 320]


def _padded(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a view of the first D columns of a wider tensor whose
    other 8 columns are NaN: a kernel that read past column D would put
    NaN into its result."""
    wide = torch.full(x.shape[:-1] + (x.shape[-1] + 8,), float("nan"),
                      dtype=x.dtype, device=x.device)
    wide[..., :x.shape[-1]] = x
    return wide[..., :x.shape[-1]]


def _new_instances(counter, before: dict) -> dict:
    """The plan tallies (head dim, instance, passes, padded) ``counter``
    gained since ``before`` (a copy of its ``by_size``)."""
    return {k: n - before.get(k, 0) for k, n in counter.by_size.items()
            if n > before.get(k, 0)}


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 16)])
@pytest.mark.parametrize("dt", list(ATT_DTYPES))
@pytest.mark.parametrize("d", ANY_D)
def test_flash_attention_any_head_dim_on_its_instance_on_card(
        cuda_device, d, dt, causal, window):
    """The forward at a head dim between the instances (or whose rows are
    not whole 16-byte chunks, or past 256), recurrentgemma's MQA and a GQA
    shape, ragged S: against the plain version; the launcher reports the
    plan ``plan_of`` gives and, in bf16 up to 256, the tensor cores;
    inputs whose rows run on past column D (NaN there) give the same
    output, and so do (B, S, H, D) views; with ``return_lse`` the f32
    output rounds to the output and lse holds 1e-5."""
    dtype, tol = ATT_DTYPES[dt]
    plan = fa.plan_of(d, dtype)
    kw = dict(causal=causal, window=window)
    for b, h, kh, s in ((1, 4, 1, 300), (2, 8, 2, 129)):
        q = _randn((b, h, s, d), dtype, cuda_device, d + s)
        k, v = (_randn((b, kh, s, d), dtype, cuda_device, d + s + i)
                for i in (1, 2))
        i0, t0 = dict(fa.counter_instance.by_size), fa.counter_tc.count
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        assert _new_instances(fa.counter_instance, i0) == {plan: 1}
        assert fa.counter_tc.count - t0 == (dtype == torch.bfloat16
                                             and plan.passes == 1)
        assert got.dtype == dtype and got.shape == q.shape
        _assert_close(got, want, tol)
        padded = [_padded(x) for x in (q, k, v)]
        assert torch.equal(fa.flash_attention_cuda(*padded, **kw), got)
        tr = [x.transpose(1, 2).contiguous().transpose(1, 2)
              for x in (q, k, v)]
        _assert_close(fa.flash_attention_cuda(*tr, **kw), want, tol)
        out, lse, out32 = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                                  **kw)
        assert torch.equal(out, got)
        assert torch.equal(out32.to(dtype), out)
        _, lse_ref, _ = fa.flash_attention_ref(q, k, v, return_lse=True, **kw)
        torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", list(ATT_DTYPES))
@pytest.mark.parametrize("d", ANY_D)
def test_flash_attention_bwd_any_head_dim_on_its_instance_on_card(
        cuda_device, d, dt):
    """The backward at those head dims against its plain version
    (``BWD_TOL``; dense, through views and the same bits again), causal
    with recurrentgemma's smoke window, MQA, ragged S, and non-causal GQA;
    the launcher reports the plan, and at the W-256 instance in bf16 in
    one pass the dK/dV plan ``bwd_head_groups`` gives on this card."""
    dtype = ATT_DTYPES[dt][0]
    plan = fa.plan_of(d, dtype)
    w = plan.w
    for b, h, kh, s, causal, window in ((1, 4, 1, 300, True, 16),
                                        (2, 8, 2, 129, False, 0)):
        i0 = dict(fa.counter_bwd_instance.by_size)
        p0 = dict(fa.counter_bwd_plan.by_size)
        _check_bwd_on_card(cuda_device, dtype, b, h, kh, s, d, causal,
                           window)
        assert _new_instances(fa.counter_bwd_instance, i0) == {plan: 3}
        groups = (fa.bwd_head_groups(b, kh, h // kh, s,
                                     pa.fill_blocks(cuda_device))
                  if dtype == torch.bfloat16 and w in fa.BWD_GROUPED_DIMS
                  and plan.passes == 1 else 1)
        assert {p.head_groups for p in _new_instances(
            fa.counter_bwd_plan, p0)} == {groups}


@pytest.mark.parametrize("dt", list(ATT_DTYPES))
@pytest.mark.parametrize("h,kh,d", [(4, 1, 16), (8, 2, 48), (4, 1, 72),
                                    (16, 16, 80), (8, 1, 136), (16, 1, 200),
                                    (8, 2, 6), (8, 2, 20), (4, 1, 264),
                                    (8, 2, 512)])
def test_paged_attention_any_head_dim_on_its_instance_on_card(cuda_device,
                                                              dt, h, kh, d):
    """Decode at head dims between the paged instances (recurrentgemma's
    smoke D 16 with its 4 query heads on one kv head; D 80, which paged
    runs on 96), whose rows are not whole 16-byte chunks (D 6, D 20 in
    bf16) or past 256: the serve shape at every length 1-40, a permuted
    table whose span takes three splits and the merge, and the split
    decode's f32 output and lse; pools whose rows run on past column D
    (NaN there) give the same output; the launcher reports the plan."""
    dtype, tol = ATT_DTYPES[dt]
    tol = 3e-2 if dt == "bf16" else tol
    plan = pa.plan_of(d, dtype)
    q = _randn((1, h, d), dtype, cuda_device, d)
    kp = _randn((1, 40, kh, d), dtype, cuda_device, d + 1)
    vp = _randn((1, 40, kh, d), dtype, cuda_device, d + 2)
    ident = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
    i0 = dict(pa.counter_instance.by_size)
    for n in range(1, 41):
        ln = torch.full((1,), n, dtype=torch.int32, device=cuda_device)
        _assert_close(pa.paged_attention_cuda(q, kp, vp, ident, ln),
                      pa.paged_attention_ref(q, kp, vp, ident, ln), tol)
    assert _new_instances(pa.counter_instance, i0) == {plan: 40}
    q, kp, vp, bt, ln = _pages(3, h, kh, d, 16, 80, 5, dtype, cuda_device, d)
    args = (q, kp, vp, torch.from_numpy(bt).to(cuda_device),
            torch.from_numpy(ln).to(cuda_device))
    assert pa.split_plan(80 * 16)[1] == 3
    got = pa.paged_attention_cuda(*args)
    _assert_close(got, pa.paged_attention_ref(*args), tol)
    assert torch.equal(pa.paged_attention_cuda(
        _padded(q), _padded(kp), _padded(vp), *args[3:]), got)
    out, lse = pa.paged_attention_cuda(*args, return_lse=True)
    want, want_lse = pa.paged_attention_ref(*args, return_lse=True)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)


def _gpu_kernel_names(fn, launches: int = 1) -> list[str]:
    """Names of the GPU kernels one call of ``fn()`` launches, by
    ``torch.profiler`` with CPU and CUDA activities, after a warm-up call
    (a session that records fewer than ``launches`` GPU events, the
    launches the call makes, is run again, up to five times; late in a
    long process a session may drop some or all of them, and the last
    session's list is returned, empty when it recorded none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) >= launches:
            return names
    return names


@pytest.mark.parametrize("d", [80, 96, 112])
@pytest.mark.parametrize("b,h,kh,s,causal,window", [
    (1, 4, 4, 640, True, 0),        # causal (phi-3-vision's mask)
    (2, 4, 4, 512, False, 0),       # no mask (hubert-xlarge's)
    (1, 4, 4, 700, True, 128),      # a window; S not a multiple of 64
    (1, 8, 2, 300, True, 0),        # GQA
    (2, 4, 1, 37, False, 0),        # S < 64, one kv head
    (1, 4, 2, 1000, False, 100)])   # a window without causality
def test_flash_attention_d80_d96_tensor_cores_match_plain_on_card(
        cuda_device, d, b, h, kh, s, causal, window):
    """bf16 at D 80 and 96 on the tensor cores (a 64-column box and a tail
    box of 16 or 32 columns), and at D 112 (two 64-column boxes, the
    second zero-filled past the row): the launcher reports the tensor-core kernel;
    the output within two bf16 ulps of the plain version, also through (B,
    S, H, D) storage; with ``return_lse`` the same output, the f32 output
    rounding to it and within the plain f32 output's rounding, and lse
    within 1e-5."""
    q = _randn((b, h, s, d), torch.bfloat16, cuda_device, s + d)
    k, v = (_randn((b, kh, s, d), torch.bfloat16, cuda_device, s + d + i)
            for i in (1, 2))
    kw = dict(causal=causal, window=window)
    t0 = fa.counter_tc.by_size.get(d, 0)
    out, lse, out32 = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert fa.counter_tc.by_size[d] == t0 + 1
    want, lse_ref, want32 = fa.flash_attention_ref(q, k, v, return_lse=True,
                                                   **kw)
    torch.cuda.synchronize()
    _assert_close(out, want, 2e-2)
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v, **kw))
    assert torch.equal(out32.to(torch.bfloat16), out)
    torch.testing.assert_close(out32, want32, rtol=2.0 ** -8, atol=1e-4)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)
    tr = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    _assert_close(fa.flash_attention_cuda(*tr, **kw), want, 2e-2)


@pytest.mark.parametrize("dt,d,design", [
    ("bf16", 32, "tc"), ("bf16", 64, "tc"), ("bf16", 80, "tc"),
    ("bf16", 96, "tc"), ("bf16", 112, "tc"), ("bf16", 128, "tc"),
    ("bf16", 256, "tc"), ("f32", 80, "cc"), ("f32", 96, "cc"),
    ("f32", 112, "cc"), ("f32", 128, "cc")])
def test_flash_attention_fwd_design_on_card(cuda_device, dt, d, design):
    """bf16 at every head dim (32/64/80/96/112/128/256) runs
    ``flash_fwd_bf16`` (the tensor cores); f32 ``flash_fwd_cc``: the design
    the launcher reports (``counter_tc``) and, where the profiler records
    the call, one kernel, the design's entry."""
    dtype = ATT_DTYPES[dt][0]
    assert (d in fa.FWD_TENSOR_CORE_DIMS and dt == "bf16") == (design == "tc")
    q = _randn((1, 4, 256, d), dtype, cuda_device, 1)
    k, v = (_randn((1, 2, 256, d), dtype, cuda_device, i) for i in (2, 3))
    c0, t0 = fa.counter.count, fa.counter_tc.count
    fa.flash_attention_cuda(q, k, v)
    assert fa.counter.count == c0 + 1
    assert fa.counter_tc.count == t0 + (design == "tc")
    names = _gpu_kernel_names(lambda: fa.flash_attention_cuda(q, k, v))
    if names:
        assert len(names) == 1, names
        assert ("flash_fwd_bf16" if design == "tc" else "flash_fwd_cc") \
            in names[0], names


@pytest.mark.parametrize("dt,d,design", [
    ("bf16", 32, "tc"), ("bf16", 64, "tc"), ("bf16", 128, "tc"),
    ("bf16", 80, "tc"), ("bf16", 96, "tc"), ("bf16", 112, "tc"),
    ("bf16", 256, "tc"), ("f32", 64, "cc"), ("f32", 80, "cc"),
    ("f32", 112, "cc"), ("f32", 128, "cc")])
def test_flash_attention_bwd_design_on_card(cuda_device, dt, d, design):
    """bf16 at every D runs the tensor-core entries; f32 the CUDA-core
    ``flash_bwd_dkdv`` and ``flash_bwd_dq``: the design the launcher
    reports (``counter_bwd_tc``) and, where the profiler records the call,
    three kernels, one of each of the design's entries, and a fourth, the
    reduce, where the launcher reports a dK/dV pass split over head groups
    (D 256 here: 8 blocks of 64 keys, g 2)."""
    dtype = ATT_DTYPES[dt][0]
    assert (d in fa.BWD_TENSOR_CORE_DIMS and dt == "bf16") == (design == "tc")
    q, do = (_randn((1, 4, 256, d), dtype, cuda_device, i) for i in (1, 2))
    k, v = (_randn((1, 2, 256, d), dtype, cuda_device, i) for i in (3, 4))
    _, lse, out = fa.flash_attention_cuda(q, k, v, return_lse=True)
    c0, t0 = fa.counter_bwd.count, fa.counter_bwd_tc.count
    p0 = dict(fa.counter_bwd_plan.by_size)
    fa.flash_attention_bwd_cuda(q, k, v, out, do, lse)
    assert fa.counter_bwd.count == c0 + 1
    assert fa.counter_bwd_tc.count == t0 + (design == "tc")
    (plan,) = [p for p, n in fa.counter_bwd_plan.by_size.items()
               if n > p0.get(p, 0)]
    assert (plan.head_groups > 1) == (design == "tc" and d == 256), plan
    want = (("flash_bwd_delta", "flash_bwd_dkdv_bf16", "flash_bwd_dq_bf16")
            if design == "tc" else
            ("flash_bwd_delta", "flash_bwd_dkdv<", "flash_bwd_dq<"))
    if plan.head_groups > 1:
        want += ("flash_bwd_reduce_bf16",)
    names = _gpu_kernel_names(
        lambda: fa.flash_attention_bwd_cuda(q, k, v, out, do, lse),
        len(want))
    if names:
        assert len(names) == len(want), names
        for w in want:
            assert sum(w in n for n in names) == 1, (w, names)


@pytest.mark.parametrize("upstream", ["dense", "broadcast"])
def test_flash_fn_on_card_matches_cpu(cuda_device, upstream):
    """``gqa_attention``'s gradients through ``_FlashFn`` on the card (both
    kernels) against the CPU's plain backward, f32; the output's gradient
    dense, or broadcast from a sum (stride 0)."""
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal((2, 256, h, 64)).astype(np.float32)
            for h in (8, 2, 2, 8)]
    grads = {}
    for dev in ("cpu", cuda_device):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_(True)
                   for a in arrs[:3])
        out = tatt.gqa_attention(q, k, v, causal=True, window=100, chunk=64)
        if upstream == "dense":
            out.backward(torch.from_numpy(arrs[3]).to(dev))
        else:
            out.sum().backward()
        grads[str(dev)] = [t.grad.cpu() for t in (q, k, v)]
    for g, w in zip(grads[str(cuda_device)], grads["cpu"]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,h,kh,s,d,causal,window", [
    (1, 4, 2, 512, 128, True, 0), (1, 4, 2, 512, 64, False, 0),
    (1, 4, 2, 512, 128, True, 100), (1, 4, 2, 300, 64, True, 0),
    (1, 4, 2, 512, 32, True, 0), (1, 4, 4, 256, 80, False, 0),
    (1, 4, 4, 256, 96, True, 0)])
def test_flash_fn_backward_takes_delta_from_f32_out_on_card(
        cuda_device, b, h, kh, s, d, causal, window):
    """``gqa_attention``'s bf16 gradients through ``_FlashFn`` (the forward
    kernel's f32 output saved for the backward, as the reference saves its
    f32 output) have no element beyond ``BWD_TOL`` of the plain backward
    fed the plain forward's f32 output, in the cases of the CPU emulation
    (tests/test_torch_kernel_designs.py)."""
    from repro_torch.models.attention import gqa_attention
    kw = dict(causal=causal, window=window)
    q, do = (_randn((b, h, s, d), torch.bfloat16, cuda_device, i)
             for i in (1, 4))
    k, v = (_randn((b, kh, s, d), torch.bfloat16, cuda_device, i)
            for i in (2, 3))
    leaves = [x.transpose(1, 2).detach().requires_grad_(True)
              for x in (q, k, v)]
    c0 = fa.counter_bwd.count
    out = gqa_attention(*leaves, **kw)
    got = [g.transpose(1, 2) for g in torch.autograd.grad(
        out, leaves, do.transpose(1, 2))]
    assert fa.counter_bwd.count == c0 + 1
    _, lse, o32 = fa.flash_attention_ref(q, k, v, return_lse=True, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, o32, do, lse, **kw)
    assert_grads_close(got, want, torch.bfloat16, f"{b, h, kh, s, d}")


def test_training_step_on_card_matches_cpu(cuda_device):
    """The smoke ``qwen3-0.6b``'s loss and every gradient leaf on the card
    against the same weights on the CPU (bf16: the leaf norms within 2e-2,
    the bound of tests/test_torch_train.py), every leaf's gradient present
    and nonzero on the card, and both attention kernels launched once a
    layer (the forward twice under remat)."""
    from repro_torch.train.optimizer import tree_leaves, tree_map
    cfg = get_config("qwen3-0.6b", smoke=True)
    pc = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 129)))
    out = {}
    for dev in ("cpu", cuda_device):
        params = tree_map(lambda p: p.detach().to(dev).requires_grad_(True),
                          pc)
        f0, b0 = fa.counter.count, fa.counter_bwd.count
        loss, _ = Model(cfg, device=dev).loss_fn(
            params, {"tokens": toks[:, :-1].to(dev),
                     "targets": toks[:, 1:].to(dev)})
        loss.backward()
        out[str(dev)] = (float(loss.detach()),
                         [p.grad for p in tree_leaves(params)])
        if dev != "cpu":
            assert fa.counter.count - f0 == 2 * cfg.n_layers
            assert fa.counter_bwd.count - b0 == cfg.n_layers
    lc, gc = out["cpu"]
    lg, gg = out[str(cuda_device)]
    assert abs(lg - lc) <= 2e-3 * abs(lc)
    for g, w in zip(gg, gc):
        assert g is not None and bool(g.abs().sum() > 0)
        rel = float((g.float().cpu() - w.float()).norm() / w.float().norm())
        assert rel <= 2e-2, rel


def _chip_smoke():
    """``chip_smoke.py`` as a module (its phase helpers take ``dev``)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "hubert-xlarge",
                                  "phi-3-vision-4.2b"])
def test_family_training_step_on_card_matches_cpu(cuda_device, arch):
    """``chip_smoke.py`` phase 15's check of a family's training step:
    the loss and every gradient leaf at 2 layers of full width (the hybrid
    6), B 1 x S 256, on the card against the CPU on the same weights and
    batch (``TRAIN_TOL``, the hybrid's leaves 6e-2), every leaf's gradient
    present and nonzero on the card (the encoder's unread token embedding
    none on either side); the MoE replays the CPU's expert choices, its
    own held to ``FLIP_MAX``."""
    smoke = _chip_smoke()
    smoke.train_vs_cpu(cuda_device, torch.cuda.get_device_name(0), arch)


def test_head_dim_112_training_step_on_card_matches_cpu(cuda_device):
    """``chip_smoke.py`` phase 15's check of head dim 112 in training
    (``TRAIN_D112``): kimi-k2-1t-a32b's smoke config with ``head_dim``
    112, its loss and every gradient leaf on the card (the backward's
    D-112 instance on the tensor cores) against the CPU."""
    smoke = _chip_smoke()
    arch = smoke.TRAIN_D112["arch"]
    tc0 = fa.counter_bwd_tc.by_size.get(112, 0)
    smoke.train_vs_cpu(cuda_device, torch.cuda.get_device_name(0), arch,
                       dataclasses.replace(get_config(arch, smoke=True),
                                           head_dim=112))
    assert fa.counter_bwd_tc.by_size.get(112, 0) > tc0


def test_flash_attention_bwd_wrapper_checks_inputs_on_card(cuda_device):
    q = torch.zeros((1, 2, 8, 32), device=cuda_device)
    lse = torch.zeros((1, 2, 8), device=cuda_device)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_cuda(q, q, q, q, q, lse.double())
    with pytest.raises(ValueError, match="fit q"):
        fa.flash_attention_bwd_cuda(q, q, q, q, q, lse[:, :, :4])
    with pytest.raises(ValueError, match="out is torch.bfloat16"):
        qb = q.to(torch.bfloat16)     # the output must come in f32
        fa.flash_attention_bwd_cuda(qb, qb, qb, qb, qb, lse)
    with pytest.raises(ValueError, match="head dim 264"):
        z = torch.zeros((1, 2, 8, 264), device=cuda_device)
        fa.flash_attention_bwd_cuda(z, z, z, z, z, lse)
