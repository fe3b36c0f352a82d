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
