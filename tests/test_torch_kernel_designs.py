"""The arithmetic of the port's attention kernels, on the CPU, against the
JAX reference, so that it is held to the reference before it runs on a card.

* ``flash_attention`` (bf16, tensor cores): a plain emulation of the
  kernel's arithmetic -- bf16 operands, f32 scores summed over 16-column
  k-steps and scaled after the product in log2 units, an online softmax
  over 64-key tiles, P split into bf16 ``hi`` and ``lo = bf16(P - hi)``
  with both products summed in f32 -- stays within two bf16 ulps (|diff|
  <= 2^-6 |want| + 1e-5, the check of ``chip_smoke.py``) of the port's and
  the JAX package's ``flash_attention_ref``.  The same emulation with one
  bf16 P does not, on the same inputs: that is why the kernel splits P.
  At D 80 and 96 the kernel reads a row as a 64-column box and a tail box
  of 16 or 32 columns, every product at the true width, as the emulation
  does; on inputs padded with zero columns to whole boxes (128) it gives
  the same bits (the zero k-steps add exact zeros, the zero output columns
  are cut off).  The head dims each direction runs on the tensor cores are
  those of ``csrc/attention_common.cuh``.
* ``flash_attention_bwd`` (bf16, tensor cores): a plain emulation of the
  two passes' arithmetic -- bf16 q, k, v and dO, the forward's f32 output
  (the one the forward kernel writes for training, emulated above); f32 S
  and dP summed over 16-column k-steps; P = exp2(S scale log2 e - lse
  log2 e) under the masks; dS = P
  (dP - delta); P and dS rounded to bf16 as hi + lo, both multiplied into
  f32 accumulators, dK and dV over 64-row query tiles and the group's
  heads, dQ over 64-key tiles; the scale at the store -- has no element
  beyond the backward's bf16 tolerance (``BWD_TOL``: rtol 2^-6, atol 1e-4
  x max(1, max |want|)) of the port's ``flash_attention_bwd_ref`` fed the
  same f32 output, nor of the JAX reference's ``jax.vjp`` of
  ``gqa_attention`` in f32 on the same bf16 values.  Fed the bf16 output
  instead, delta moves by its rounding and both backwards miss the f32
  gradient: that is why the forward writes its f32 output for training.
  With one bf16 P, dV misses it; with one bf16 dS, dQ and dK do: that is
  why the kernel splits both.  At D 80 and 96 (hubert-xlarge's and
  phi-3-vision's) a row is read as the forward's 64-column box and tail
  box, and gives the same bits as tiles padded with zero columns to 128.
* ``paged_attention`` (flash decoding): ``paged_attention_split_ref``, the
  split-and-merge the kernel computes, equals ``paged_attention_ref``, the
  JAX reference and the Pallas kernel in interpret mode, at splits and
  lengths on and around the split boundaries; so does an emulation of the
  kernel's blocks with a kv head's query heads split into groups (each
  block's partials written where the kernel writes them, then merged as
  the merge launch does).
* every head dim (``plan_of``): the plan of each D 1-1,024; past 256 the
  column-pass forward and backward (scores summed over 256-column chunks,
  each pass recomputing them and accumulating its own output columns)
  within two bf16 ulps / ``BWD_TOL`` of both references and the bits of
  one pass over the whole row; D 20 in bf16 on its padded copies (the
  32-column tensor-core tiles) the bits of the true width; paged's
  column-pass blocks at D 264 against the references and the Pallas
  kernel in interpret mode.
* the launcher's plans: ``split_plan`` sizes the split from the block
  table's span, and one split (the serve's shape) means one launch;
  ``head_group_plan`` splits the query heads of a kv head only while the
  grid is short of one block a streaming multiprocessor (132 on an H100
  SXM, 114 on an H100 PCIe).
* ``wc_combine`` (one launch, tiled single pass): an emulation of the
  kernel's tiles -- neighbour flags, the thread-serial, warp and block
  max-scans of head indices, and one warp's 32-way search for the start of
  a run that enters the tile -- equals the JAX reference and the Pallas
  kernel in interpret mode at every tile edge, with the kernel's tile and a
  small one that puts a run across dozens of tiles.
* ``scan_probe`` (one launch, decoupled look-back): an emulation of the
  kernel's tiles, status words and look-back, with the blocks interleaved
  at random over stale words of an earlier call, equals the same
  references; the look-back stops at the first inclusive prefix or run
  head; the 64-bit status word round-trips, and its epoch wraps through a
  zeroed scratch.
"""
from __future__ import annotations

import functools
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as j_flash_ref)
from repro.models import attention as jatt  # noqa: E402
from repro.kernels.paged_attention.ops import paged_attention_op  # noqa: E402
from repro.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref as j_paged_ref)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    NEG_INF, flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref, paged_attention_split_ref)
from repro.kernels.scan_probe.ops import scan_probe_op  # noqa: E402
from repro.kernels.scan_probe.ref import (  # noqa: E402
    scan_probe_ref as j_scan_probe_ref)
from repro.kernels.wc_combine.ops import wc_combine_op  # noqa: E402
from repro.kernels.wc_combine.ref import (  # noqa: E402
    wc_combine_ref as j_wc_combine_ref)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.scan_probe import ops as sp  # noqa: E402
from repro_torch.kernels.scan_probe import ref as spr  # noqa: E402
from repro_torch.kernels.wc_combine import ops as wcc  # noqa: E402

j_flash_ref = jax.jit(j_flash_ref, static_argnames=("causal", "window"))
j_paged_ref = jax.jit(j_paged_ref)


def _bf16(rng, shape):
    """Seeded normal values rounded once to bf16, as a JAX array and a CPU
    tensor with the same bits."""
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                    jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def padded_width(d: int) -> int:
    """D rounded up to whole boxes of 64 columns (32 at D 32): the tile
    width of the padded design, 128 at D 80, 96 and 112 (D 112's tiles
    are that design's: zeros past column 111)."""
    box = 32 if d == 32 else 64
    return -(-d // box) * box


def flash_tensor_core_emulation(q, k, v, *, causal, window, split_p,
                                block_k=64, f32_out=False, width=None):
    """The bf16 tensor-core kernel's arithmetic in plain PyTorch: q (B, H,
    S, D), k/v (B, KH, S, D) in bf16; scores in f32 summed over 16-column
    k-steps (the kernel's wgmma k-steps) and times D^-1/2 log2 e; the
    reference's masks (-1e30); (m, l, acc) in f32 over tiles of ``block_k``
    keys with exp2; P rounded to bf16 once (``split_p`` False) or as hi +
    lo; the output rounded once to bf16, or with ``f32_out`` the f32 output
    before that rounding (what the kernel writes for the backward).  With
    ``width``, q, k and v are first padded with zero columns to that many
    (the padded design's tiles) and the output cut back to D."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    c = d ** -0.5 * math.log2(math.e)
    if width is not None:
        q, k, v = (torch.nn.functional.pad(x, (0, width - d))
                   for x in (q, k, v))
    k = k.repeat_interleave(g, 1).float()
    v = v.repeat_interleave(g, 1).float()
    qf = q.float()
    m = torch.full((b, h, s), NEG_INF)
    l_ = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, q.shape[-1]))
    qp = torch.arange(s)[:, None]
    for k0 in range(0, s, block_k):
        kp = torch.arange(k0, min(k0 + block_k, s))[None, :]
        kt = k[:, :, k0:k0 + block_k]
        sc = torch.zeros((b, h, s, kt.shape[2]))
        for c0 in range(0, q.shape[-1], 16):
            sc = sc + qf[..., c0:c0 + 16] @ kt[..., c0:c0 + 16].transpose(
                -1, -2)
        sc = sc * c
        ok = torch.ones((s, kp.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kp <= qp
        if window:
            ok &= kp > qp - window
        sc = torch.where(ok, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new[..., None])
        hi = p.to(torch.bfloat16).float()
        vt = v[:, :, k0:k0 + block_k]
        pv = hi @ vt
        if split_p:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        l_ = l_ * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = (acc / l_.clamp(min=1e-30)[..., None])[..., :d]
    return out if f32_out else out.to(torch.bfloat16)


def _beyond_two_ulps(got, want) -> int:
    got, want = got.float(), want.float()
    return int(((got - want).abs() > 1e-5 + 2.0 ** -6 * want.abs()).sum())


FLASH_CASES = [
    (1, 4, 4, 2048, 128, True, 0),    # the case the split was chosen on
    (1, 4, 2, 512, 128, True, 0),     # GQA, the model's D
    (1, 4, 2, 512, 64, False, 0),     # no mask
    (1, 4, 2, 512, 32, True, 100),    # a window that ends inside a tile
    (2, 2, 1, 300, 64, False, 100),   # ragged S, window without causality
    (2, 4, 4, 300, 80, False, 0),     # hubert-xlarge's: D 80, no mask, ragged
    (1, 4, 4, 600, 96, True, 0),      # phi-3-vision's: D 96, causal, ragged
    (1, 4, 2, 512, 80, True, 100),    # D 80 with GQA and a window
    (1, 4, 1, 320, 256, True, 64),    # recurrentgemma's: D 256, windowed MQA
    (1, 2, 1, 200, 256, False, 0),    # D 256, no mask, ragged
    (1, 8, 1, 512, 112, True, 0),     # kimi-k2-1t-a32b's: D 112, g 8
    (2, 4, 2, 300, 112, False, 100),  # D 112, ragged, a window
]


@pytest.mark.parametrize("b,h,kh,s,d,causal,window", FLASH_CASES)
def test_flash_split_p_within_two_ulps_single_p_not(b, h, kh, s, d, causal,
                                                     window):
    rng = np.random.default_rng(7)
    (qj, qt), (kj, kt), (vj, vt) = (_bf16(rng, x) for x in (
        (b, h, s, d), (b, kh, s, d), (b, kh, s, d)))
    want_t = flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    want_j = torch.from_numpy(np.array(j_flash_ref(
        qj, kj, vj, causal=causal, window=window).astype(jnp.float32)))
    kw = dict(causal=causal, window=window)
    split = flash_tensor_core_emulation(qt, kt, vt, split_p=True, **kw)
    assert split.dtype == torch.bfloat16 and split.shape == qt.shape
    # tiles padded with zero columns to whole boxes give the same bits
    padded = flash_tensor_core_emulation(qt, kt, vt, split_p=True,
                                         width=padded_width(d), **kw)
    assert torch.equal(padded, split)
    assert _beyond_two_ulps(split, want_t) == 0
    assert _beyond_two_ulps(split, want_j) == 0
    single = flash_tensor_core_emulation(qt, kt, vt, split_p=False, **kw)
    assert _beyond_two_ulps(single, want_t) > 0
    assert _beyond_two_ulps(single, want_j) > 0


def _bf16_parts(x: torch.Tensor, split: bool) -> list[torch.Tensor]:
    """``x`` (f32) as the bf16 operands the kernel multiplies: hi =
    bf16(x), and lo = bf16(x - hi) when ``split``."""
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()] if split else [hi]


def _over_d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b^T summed over 16-column k-steps of the shared D axis, in order:
    the kernel's wgmma k-steps, through a row's 64-column boxes and then,
    at D 80 and 96, its 16- or 32-column tail box."""
    out = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for c0 in range(0, a.shape[-1], 16):
        out = out + a[..., c0:c0 + 16] @ b[..., c0:c0 + 16].transpose(-1, -2)
    return out


def flash_bwd_tensor_core_emulation(q, k, v, out, dout, lse, *, causal,
                                    window, split_p, split_ds, tile=64,
                                    width=None, n_groups=1):
    """The bf16 tensor-core backward's arithmetic in plain PyTorch: q, out,
    dout (B, H, S, D), k/v (B, KH, S, D) in bf16, lse (B, H, S) f32.  delta
    = rowsum(dout * out) in f32 (its own launch, over the D columns); S and
    dP in f32, summed over 16-column k-steps (``_over_d``); P = exp2(S
    scale log2 e - lse log2 e), 0 where masked; dS = P (dP - delta); P and
    dS as bf16 operands (hi, or hi + lo); the dK/dV pass accumulates in f32
    over ``tile``-row query tiles and, inside each, the g query heads of a
    kv head -- with ``n_groups`` > 1 (the D-256 split) each group of g /
    n_groups heads into an f32 partial of its own, the partials then summed
    in group order -- the dQ pass over ``tile``-key tiles; dK and dQ scaled
    at the store; each output rounded once to bf16.  With ``width``, q, k, v
    and dout are first padded with zero columns to that many (tiles padded
    to whole boxes) and the gradients cut back to D."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    gn = g // n_groups
    c = d ** -0.5 * math.log2(math.e)
    delta = (dout.float() * out.float()).sum(-1)
    if width is not None:
        q, k, v, dout = (torch.nn.functional.pad(x, (0, width - d))
                         for x in (q, k, v, dout))
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = dout.float()
    lse2 = lse * math.log2(math.e)
    pos = torch.arange(s)
    ok = torch.ones((s, s), dtype=torch.bool)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window:
        ok &= pos[None, :] > pos[:, None] - window

    def p_ds(hh, qs, ks):
        """P and dS of query head ``hh``'s rows ``qs`` and keys ``ks``."""
        kv = hh // g
        sc = _over_d(qf[:, hh, qs], kf[:, kv, ks])
        p = torch.where(ok[qs, ks], torch.exp2(
            sc * c - lse2[:, hh, qs, None]), 0.0)
        dp = _over_d(dof[:, hh, qs], vf[:, kv, ks])
        return p, p * (dp - delta[:, hh, qs, None])

    w = q.shape[-1]
    dk = torch.zeros((n_groups, b, kh, s, w))
    dv = torch.zeros((n_groups, b, kh, s, w))
    for q0 in range(0, s, tile):
        qs = slice(q0, min(q0 + tile, s))
        for hh in range(h):
            grp = hh % g // gn
            p, ds = p_ds(hh, qs, slice(0, s))
            for part in _bf16_parts(p, split_p):
                dv[grp, :, hh // g] += part.transpose(-1, -2) @ dof[:, hh, qs]
            for part in _bf16_parts(ds, split_ds):
                dk[grp, :, hh // g] += part.transpose(-1, -2) @ qf[:, hh, qs]
    dk, dv = (functools.reduce(torch.add, x.unbind(0)) for x in (dk, dv))
    dq = torch.zeros((b, h, s, w))
    for k0 in range(0, s, tile):
        ks = slice(k0, min(k0 + tile, s))
        for hh in range(h):
            _, ds = p_ds(hh, slice(0, s), ks)
            for part in _bf16_parts(ds, split_ds):
                dq[:, hh] += part @ kf[:, hh // g, ks]
    scale = d ** -0.5
    return tuple(x[..., :d].to(torch.bfloat16)
                 for x in (dq * scale, dk * scale, dv))


def _beyond_bwd_tol(got, want) -> int:
    """Elements of ``got`` beyond the backward's bf16 tolerance of
    ``want`` (``BWD_TOL`` of ``chip_smoke.py`` and tests/test_torch_cuda.py:
    rtol 2^-6, atol 1e-4 x max(1, max |want|))."""
    got, want = got.float(), want.float()
    atol = 1e-4 * max(float(want.abs().max()), 1.0)
    return int(((got - want).abs() > atol + 2.0 ** -6 * want.abs()).sum())


BWD_EMU_CASES = [
    (1, 4, 2, 512, 128, True, 0),    # the training shape, cut in B, H, S
    (1, 4, 2, 512, 64, False, 0),    # no mask
    (1, 4, 2, 512, 128, True, 100),  # a window that ends inside a tile
    (1, 4, 2, 300, 64, True, 0),     # ragged S
    (1, 4, 2, 512, 32, True, 0),     # D 32 (64-byte swizzle)
    (1, 4, 4, 256, 80, False, 0),    # hubert-xlarge's: D 80, no mask
    (1, 4, 4, 256, 96, True, 0),     # phi-3-vision's: D 96, causal
    (1, 4, 1, 320, 256, True, 64),   # recurrentgemma's: D 256, windowed MQA
    (1, 8, 1, 256, 112, True, 0),    # kimi-k2-1t-a32b's: D 112, g 8
]


@pytest.mark.parametrize("b,h,kh,s,d,causal,window", BWD_EMU_CASES)
def test_flash_bwd_split_p_and_ds_within_tolerance_single_not(
        b, h, kh, s, d, causal, window):
    rng = np.random.default_rng(11)
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (_bf16(rng, x) for x in (
        (b, h, s, d), (b, kh, s, d), (b, kh, s, d), (b, h, s, d)))
    kw = dict(causal=causal, window=window)
    _, lse, out32 = flash_attention_ref(qt, kt, vt, return_lse=True, **kw)
    # the f32 output the forward kernel saves for the backward
    out = flash_tensor_core_emulation(qt, kt, vt, split_p=True, f32_out=True,
                                      **kw)
    assert out.dtype == torch.float32
    want_t = flash_attention_bwd_ref(qt, kt, vt, out32, dot, lse, **kw)
    # the JAX reference's backward in f32 on the same bf16 values, in its
    # (B, S, heads, D) layout
    j32 = [x.astype(jnp.float32).transpose(0, 2, 1, 3)
           for x in (qj, kj, vj, doj)]
    chunk = 128 if s % 128 == 0 else s
    j_out, vjp = jax.vjp(lambda q_, k_, v_: jatt.gqa_attention(
        q_, k_, v_, chunk=chunk, **kw), *j32[:3])
    want_j = [torch.from_numpy(np.array(x)).transpose(1, 2)
              for x in vjp(j32[3])]
    # the port's plain backward fed the f32 output is the JAX one
    assert [_beyond_bwd_tol(x, w) for x, w in zip(want_t, want_j)] == [0] * 3

    def emulate(split_p, split_ds, o=out, width=None):
        return flash_bwd_tensor_core_emulation(
            qt, kt, vt, o, dot, lse, split_p=split_p, split_ds=split_ds,
            width=width, **kw)

    def beyond(got):
        for x, w in zip(got, want_t):
            assert x.dtype == torch.bfloat16 and x.shape == w.shape
        return [(_beyond_bwd_tol(x, w), _beyond_bwd_tol(x, wj))
                for x, w, wj in zip(got, want_t, want_j)]

    # (dq, dk, dv), each (beyond the port's ref, beyond the JAX vjp)
    split = emulate(True, True)
    assert beyond(split) == [(0, 0)] * 3
    if padded_width(d) != d:
        # a row read as a 64-column box and a tail box (D 112: as whole
        # boxes whose products stop at the true width) gives the bits of
        # tiles padded with zero columns to whole boxes (128)
        padded = emulate(True, True, width=padded_width(d))
        assert all(torch.equal(x, y) for x, y in zip(split, padded))
    if d in fa.BWD_GROUPED_DIMS:
        # the dK/dV pass split over the head groups the launcher picks on
        # an H100 SXM (132 SMs): the groups' f32 partials summed in group
        # order, then rounded once; dq is the unsplit one
        n = fa.bwd_head_groups(b, kh, h // kh, s, 132)
        assert n > 1
        grouped = flash_bwd_tensor_core_emulation(
            qt, kt, vt, out, dot, lse, split_p=True, split_ds=True,
            n_groups=n, **kw)
        assert beyond(grouped) == [(0, 0)] * 3
        assert torch.equal(grouped[0], split[0])
    if (b, h, kh, s, d, causal, window) == BWD_EMU_CASES[0]:
        # fed the bf16 output, as the card's residual was before, dq and dk
        # miss the f32 gradient
        bf16_out = beyond(emulate(True, True, out.to(torch.bfloat16)))
        assert bf16_out[0][1] > 0 and bf16_out[1][1] > 0
    single_p = beyond(emulate(False, True))
    assert single_p[:2] == [(0, 0)] * 2
    assert min(single_p[2]) > 0
    single_ds = beyond(emulate(True, False))
    assert min(single_ds[0]) > 0 and min(single_ds[1]) > 0
    assert single_ds[2] == (0, 0)


def _paged_case(rng, b, h, kh, d, page, np_, dtype):
    npool = b * np_ + 3
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((npool, page, kh, d)).astype(np.float32)
    vp = rng.standard_normal((npool, page, kh, d)).astype(np.float32)
    bt = rng.permutation(npool)[: b * np_].reshape(b, np_).astype(np.int32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    js = [jnp.asarray(x, jdt) for x in (q, kp, vp)]
    ts = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)
          for x in js]
    return js, ts, bt


def _lengths_around(split: int, span: int) -> list[int]:
    """0, 1, the split boundaries (split - 1, split, split + 1) and their
    doubles, and the full span, within [0, span]."""
    cand = [0, 1, split - 1, split, split + 1, 2 * split - 1, 2 * split,
            2 * split + 1, span]
    return sorted({n for n in cand if 0 <= n <= span})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split", [1, 16, 64, 512])
def test_paged_split_merge_equals_reference(split, dtype):
    rng = np.random.default_rng(split)
    b, h, kh, d, page, np_ = 3, 4, 2, 32, 16, 40     # a 640-row span
    (qj, kj, vj), (qt, kt, vt), bt = _paged_case(rng, b, h, kh, d, page, np_,
                                                 dtype)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    lengths = _lengths_around(split, np_ * page)
    for i in range(0, len(lengths), b):
        ln = np.array((lengths[i:i + b] + lengths[:b])[:b], np.int32)
        got = paged_attention_split_ref(qt, kt, vt, torch.from_numpy(bt),
                                        torch.from_numpy(ln), split)
        assert got.dtype == dtype and got.shape == qt.shape
        assert torch.isfinite(got).all()
        want = paged_attention_ref(qt, kt, vt, torch.from_numpy(bt),
                                   torch.from_numpy(ln))
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        want_j = j_paged_ref(qj, kj, vj, jnp.asarray(bt), jnp.asarray(ln))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want_j, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("split", [16, 64])
def test_paged_split_merge_equals_pallas_interpret(split):
    """Against the Pallas kernel itself (interpret mode, as
    ``tests/test_kernels.py`` runs it), in f32, lengths 0 and 1 and on a
    split boundary; the span is 96 rows, so 2-6 splits."""
    rng = np.random.default_rng(split + 1)
    (qj, kj, vj), (qt, kt, vt), bt = _paged_case(rng, 3, 4, 2, 32, 16, 6,
                                                 torch.float32)
    ln = np.array([0, 1, split], np.int32)
    got = paged_attention_split_ref(qt, kt, vt, torch.from_numpy(bt),
                                    torch.from_numpy(ln), split)
    want = paged_attention_op(qj, kj, vj, jnp.asarray(bt), jnp.asarray(ln),
                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("span,split,n_split", [
    (1, 512, 1), (40, 512, 1),          # the serve's 40-row slot: one launch
    (512, 512, 1), (513, 512, 2),
    (4096, 512, 8), (32768, 512, 64),   # decode_32k's span
    (512 * 65535, 512, 65535),
    (512 * 65535 + 1, 544, 61681),      # past 65,535 blocks: a longer split
])
def test_paged_split_plan(span, split, n_split):
    got_split, got_n = pa.split_plan(span)
    assert (got_split, got_n) == (split, n_split)
    assert got_split % pa.TILE == 0 and got_n <= 65535
    assert got_split * (got_n - 1) < span <= got_split * got_n


def test_paged_split_plan_of_the_serve_and_decode_32k_shapes():
    """The wrapper plans from NP * page: the serve (one 40-row page) runs
    one split, so one launch per call; decode_32k (2048 pages of 16 rows)
    runs 64 splits and the merge."""
    assert pa.split_plan(1 * 40)[1] == 1
    assert pa.split_plan(2048 * 16) == (pa.SPLIT, 64)


SXM, PCIE = 132, 114   # streaming multiprocessors of an H100 SXM, PCIe


@pytest.mark.parametrize("b,kh,g,span,fill,n_hgroups", [
    (1, 1, 16, 40, SXM, 16),    # recurrentgemma's serve slot: 1 -> 16 blocks
    (1, 1, 16, 2048, SXM, 16),  # its full ring: 4 splits -> 64 blocks
    (1, 1, 16, 33 * 512, SXM, 4),   # 33 splits: 4 groups reach 132 blocks
    (1, 1, 16, 65536, SXM, 2),  # 128 splits: 2 groups
    (8, 8, 2, 32768, SXM, 1),   # decode_32k: 4,096 blocks already
    (64, 8, 2, 4096, SXM, 1),   # the split decode's 64 parts: 4,096 blocks
    (1, 8, 2, 40, SXM, 2),      # qwen3-0.6b's serve slot: 8 -> 16 blocks
    (1, 32, 1, 40, SXM, 1),     # phi-3-vision: g = 1, nothing to split
    (1, 16, 1, 40, SXM, 1),     # deepseek-moe: g = 1
    (1, 2, 6, 40, SXM, 6),      # g = 6: every divisor short, 6 groups
    (1, 2, 6, 32 * 512, SXM, 3),    # 64 blocks: 3 groups of 2 heads reach 192
    (66, 1, 4, 40, SXM, 2),     # 66 blocks: 2 groups reach 132
    (1, 1, 16, 15 * 512, SXM, 16),  # 15 splits: 8 groups give 120 < 132
    (1, 1, 16, 15 * 512, PCIE, 8),  # ... and fill a card of 114 SMs
])
def test_paged_head_group_plan(b, kh, g, span, fill, n_hgroups):
    got = pa.head_group_plan(b, kh, g, span, fill)
    assert got == n_hgroups
    assert g % got == 0
    blocks = b * kh * pa.split_plan(span)[1]
    # the fewest groups that reach `fill` blocks, or all g when none does
    assert blocks * got >= fill or got == g
    assert all(blocks * d < fill for d in range(1, got) if g % d == 0)


def paged_head_group_emulation(q, k_pages, v_pages, block_table, lengths,
                               split, n_hgroups):
    """The kernel's blocks in plain PyTorch (f32): block (x, b, sp) of the
    grid (KH x n_hgroups, B, n_split) takes kv head x // n_hgroups and its
    query heads h0 .. h0 + gh - 1 (h0 = kv head x g + (x % n_hgroups) gh),
    over positions [sp split, (sp + 1) split) of the sequence's (its
    length, clipped to the span, or the whole span for a length <= 0);
    it writes the output itself with one split, else (acc, m, l) of each
    of its heads into the (B, KH, n_split, g, D + 2) scratch at the
    kernel's offset, and the merge combines each head's splits that ran by
    exp(m - max m)."""
    b, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    g, span = h // kh, block_table.shape[1] * page
    gh = g // n_hgroups
    n_split = -(-span // split)
    bt = block_table.long()
    kd = k_pages[bt].reshape(b, span, kh, d).float()
    vd = v_pages[bt].reshape(b, span, kh, d).float()
    qf = q.float() * d ** -0.5
    out = torch.full((b, h, d), float("nan"))
    part = torch.full((b * kh * n_split * g * (d + 2),), float("nan"))
    for x in range(kh * n_hgroups):
        hk = x // n_hgroups
        h0 = hk * g + (x % n_hgroups) * gh
        for bi in range(b):
            ln = int(lengths[bi])
            n_pos = min(ln, span) if ln >= 1 else span
            for sp in range(n_split):
                p0 = sp * split
                if p0 >= n_pos:
                    continue
                pos = torch.arange(p0, min(p0 + split, n_pos))
                sc = qf[bi, h0:h0 + gh] @ kd[bi, pos, hk].T
                sc = torch.where(pos < ln, sc, NEG_INF)
                m = sc.amax(-1)
                p = torch.exp(sc - m[:, None])
                acc, l_ = p @ vd[bi, pos, hk], p.sum(-1)
                if n_split == 1:
                    out[bi, h0:h0 + gh] = acc / l_.clamp(min=1e-30)[:, None]
                    continue
                off = (((bi * kh + hk) * n_split + sp) * g + h0 - hk * g) \
                    * (d + 2)
                part[off:off + gh * (d + 2)] = torch.cat(
                    [acc, m[:, None], l_[:, None]], 1).reshape(-1)
    if n_split > 1:
        for hk in range(kh):
            for bi in range(b):
                ln = int(lengths[bi])
                n_pos = min(ln, span) if ln >= 1 else span
                ran = -(-n_pos // split)
                base = (bi * kh + hk) * n_split * g * (d + 2)
                pb = part[base:base + ran * g * (d + 2)].reshape(ran, g, d + 2)
                w = torch.exp(pb[..., d] - pb[..., d].amax(0))
                den = (pb[..., d + 1] * w).sum(0).clamp(min=1e-30)
                out[bi, hk * g:(hk + 1) * g] = \
                    (pb[..., :d] * w[..., None]).sum(0) / den[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("h,kh,split,n_hgroups", [
    (8, 2, 16, 2), (8, 2, 64, 4), (8, 2, 512, 4),   # grouped, 6 / 2 / 1 splits
    (4, 1, 16, 4), (4, 1, 512, 2)])                 # MQA, as recurrentgemma
def test_paged_head_groups_equal_reference_and_pallas_interpret(
        h, kh, split, n_hgroups):
    """The head-group partition (heads x splits, then the merge) against
    ``paged_attention_ref``, the same emulation with one group (the
    unsplit heads), the JAX reference and the Pallas kernel in interpret
    mode, in f32, at lengths 0, 1, on a split boundary and the full span
    (96 rows)."""
    rng = np.random.default_rng(h * split + n_hgroups)
    (qj, kj, vj), (qt, kt, vt), bt = _paged_case(rng, 4, h, kh, 32, 16, 6,
                                                 torch.float32)
    ln = np.array([0, 1, min(split, 96), 96], np.int32)
    args = (qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(ln))
    got = paged_head_group_emulation(*args, split, n_hgroups)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, paged_attention_ref(*args), rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(got, paged_head_group_emulation(*args, split,
                                                               1),
                               rtol=2e-6, atol=2e-6)
    want_j = paged_attention_op(qj, kj, vj, jnp.asarray(bt), jnp.asarray(ln),
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_j, np.float32),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        j_paged_ref(qj, kj, vj, jnp.asarray(bt), jnp.asarray(ln)),
        np.float32), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the sort sweeps: wc_combine and scan_probe, one launch each
# ---------------------------------------------------------------------------

BIG = 2**31 - 1
SWEEP_LAYOUTS = ["one_run", "distinct", "sentinel_tail", "dup_heavy"]


def sweep_keys(layout: str, n: int, seed: int) -> np.ndarray:
    """Sorted int32 keys: one run over every tile, all distinct, a +inf
    sentinel tail (invalid lanes), random duplicate-heavy runs."""
    rng = np.random.default_rng(seed)
    if layout == "one_run":
        return np.full(n, 42, np.int32)
    if layout == "distinct":
        return np.arange(n, dtype=np.int32) * 3 - 7
    if layout == "sentinel_tail":
        k = np.sort(rng.integers(-50, 50, n)).astype(np.int32)
        k[n - n // 3:] = BIG
        return k
    return np.sort(rng.integers(0, max(n // 8, 1), n)).astype(np.int32)


def tile_edges(tile: int) -> list[int]:
    """N = 2, N at every tile edge, and ragged last tiles whose last thread
    holds two keys and three."""
    return [2, tile - 1, tile, tile + 1, 2 * tile, 2 * tile + 2,
            2 * tile + tile // 3 + 5]


def _tiles(x: torch.Tensor, n_tiles: int, threads: int, per_thread: int,
           fill: int) -> torch.Tensor:
    """``x`` padded with ``fill`` to whole tiles, as (tile, thread, lane)."""
    out = torch.full((n_tiles * threads * per_thread,), fill, dtype=x.dtype)
    out[:x.shape[0]] = x
    return out.view(n_tiles, threads, per_thread)


def warp_run_start(keys: np.ndarray, hi: int, key: int):
    """The kernel's one-warp search: the first index of [0, hi] whose key is
    >= ``key``, given ``keys[hi] == key``; each round 32 lanes probe 32
    evenly spaced keys and ballot.  Returns ``(start, rounds)``."""
    lanes = np.arange(32, dtype=np.int64)
    lo, rounds = 0, 0
    while lo < hi:
        p = lo + ((hi - lo) * (lanes + 1) >> 5)
        ge = keys[p] >= key
        assert ge[31]                              # lane 31 probes hi
        c = int(np.argmax(ge))
        lo, hi = (int(p[c - 1]) + 1 if c > 0 else lo), int(p[c])
        rounds += 1
    return lo, rounds


def _warp_scan(v: torch.Tensor, op, fill) -> torch.Tensor:
    """The kernel's inclusive scan over the last axis (32 lanes) by
    ``__shfl_up_sync`` steps 1, 2, 4, 8, 16; ``op(older, newer)``."""
    lane = torch.arange(32)
    for off in (1, 2, 4, 8, 16):
        o = torch.cat([torch.full_like(v[..., :off], fill), v[..., :-off]],
                      -1)
        v = torch.where(lane >= off, op(o, v), v)
    return v


def run_start_from_window(keys: np.ndarray, tile_start: int, key: int):
    """The kernel's run start for a tile whose first key ``key`` continues
    the run of the tile before: from the 32 keys before the tile (one
    ballot) when the run starts there, else by the warp search over
    ``[0, tile_start - 32]``.  Returns ``(start, search rounds)``."""
    window = keys[tile_start - 32:tile_start]
    in_run = window == key
    if not in_run[0]:
        return tile_start - 32 + int(np.argmax(in_run)), 0
    return warp_run_start(keys, tile_start - 32, key)


def wc_combine_tiled_emulation(keys: np.ndarray, threads: int,
                               per_thread: int):
    """``csrc/wc_combine.cu`` in plain PyTorch, every tile at once.
    Returns ``(is_first, is_last, rank, search_rounds)``; the rounds are
    those of each tile whose first key continues a run of the tile before
    (0 when the run starts in the 32 keys before the tile)."""
    n = keys.shape[0]
    tile = threads * per_thread
    n_tiles = -(-n // tile)
    k = _tiles(torch.from_numpy(keys.astype(np.int64)), n_tiles, threads,
               per_thread, 0)
    i = torch.arange(n_tiles * tile).view(k.shape)
    valid = i < n
    cnt = valid.sum(-1)
    head_key = k[..., 0]
    tail_key = k.gather(-1, (cnt - 1).clamp(min=0)[..., None])[..., 0]
    flat = k.reshape(-1)
    starts = torch.arange(n_tiles) * tile
    halo_prev = torch.where(starts > 0, flat[(starts - 1).clamp(min=0)], 0)
    halo_next = torch.where(starts + tile < n,
                            flat[(starts + tile).clamp(max=flat.numel() - 1)],
                            0)
    prev = torch.cat([halo_prev[:, None], tail_key[:, :-1]], 1)
    nxt = torch.cat([head_key[:, 1:], halo_next[:, None]], 1)
    kp = torch.cat([prev[..., None], k[..., :-1]], -1)
    kn = torch.cat([k[..., 1:], nxt[..., None]], -1)
    first = (i == 0) | (kp != k)
    last = (i == n - 1) | (kn != k)
    # thread-serial max-scan of head indices, then warp and block
    hm = torch.cummax(torch.where(first & valid, i, -1), -1).values
    run = hm[..., -1].reshape(n_tiles, threads // 32, 32)
    incl = _warp_scan(run, torch.maximum, -1)
    excl = torch.cat([torch.full_like(incl[..., :1], -1), incl[..., :-1]], -1)
    warp_tot = incl[..., 31]
    warp_before = torch.cat([torch.full_like(warp_tot[:, :1], -1),
                             torch.cummax(warp_tot, 1).values[:, :-1]], 1)
    carry = torch.full((n_tiles,), -1, dtype=torch.int64)
    rounds = []
    for t in range(1, n_tiles):
        if int(halo_prev[t]) == int(head_key[t, 0]):
            start, r = run_start_from_window(keys, int(starts[t]),
                                             int(head_key[t, 0]))
            carry[t] = start
            rounds.append(r)
    pre = torch.maximum(torch.maximum(carry[:, None, None],
                                      warp_before[..., None]), excl)
    start = torch.maximum(pre.reshape(n_tiles, threads)[..., None], hm)
    rank = (i - start).to(torch.int32)
    return (first.reshape(-1)[:n], last.reshape(-1)[:n],
            rank.reshape(-1)[:n], rounds)


def _check_wc(keys, got, pallas_block=1024):
    f, l_, r = (x.numpy() for x in got[:3])
    for want in (j_wc_combine_ref(jnp.asarray(keys)),
                 wc_combine_op(jnp.asarray(keys), block=pallas_block,
                               interpret=True)):
        wf, wl, wr = (np.asarray(x) for x in want)
        assert np.array_equal(f, wf) and np.array_equal(l_, wl)
        assert r.dtype == wr.dtype and np.array_equal(r, wr)


@pytest.mark.parametrize("n", tile_edges(wcc.TILE))
@pytest.mark.parametrize("layout", SWEEP_LAYOUTS)
def test_wc_combine_tiles_equal_reference(layout, n):
    """The kernel's own tile (128 threads x 4 keys) at every tile edge."""
    keys = sweep_keys(layout, n, seed=n)
    got = wc_combine_tiled_emulation(keys, wcc.THREADS, wcc.PER_THREAD)
    _check_wc(keys, got)
    if layout == "one_run":      # every tile after the first searches
        assert len(got[3]) == -(-n // wcc.TILE) - 1
        assert all(r > 0 for r in got[3])
    if layout == "distinct":     # no run enters a tile
        assert got[3] == []


@pytest.mark.parametrize("n", tile_edges(128) + [5000])
@pytest.mark.parametrize("layout", SWEEP_LAYOUTS)
def test_wc_combine_small_tiles_equal_reference(layout, n):
    """32 threads x 4 keys a tile: runs that cross dozens of tiles, so the
    warp search narrows over several rounds, about log32 of its span."""
    keys = sweep_keys(layout, n, seed=n + 1)
    got = wc_combine_tiled_emulation(keys, 32, 4)
    _check_wc(keys, got, pallas_block=256)
    for r in got[3]:
        assert r <= math.ceil(math.log(n, 32)) + 1


def test_warp_run_start_rounds():
    """About log32 of the span: 3 rounds at 4,096 keys, 5 at 2^20."""
    for n, most in ((4096, 3), (1 << 20, 5)):
        keys = np.full(n, 9, np.int32)
        keys[:7] = 1
        start, rounds = warp_run_start(keys, n - 1, 9)
        assert start == 7 and rounds <= most


# scan_probe --------------------------------------------------------------

def _seg_combine(a, b):
    """The kernel's segmented monoid on (head, w, c) tensors; a before b."""
    ah, aw, ac = a
    bh, bw, bc = b
    return (ah | bh, torch.where(bh == 1, bw, aw + bw),
            torch.where(bh == 1, bc, torch.where(bc >= 0, bc, ac)))


def _seg_identity(shape):
    return (torch.zeros(shape, dtype=torch.int64),
            torch.zeros(shape, dtype=torch.int64),
            torch.full(shape, -1, dtype=torch.int64))


def _py_combine(a, b):
    return _seg_combine(*(tuple(torch.tensor(x) for x in s) for s in (a, b)))


def seg_of(t) -> tuple[int, int, int]:
    return tuple(int(x) for x in t)


def look_back(status: list, tile: int, epoch: int):
    """The kernel's look-back by one warp, as a generator: it yields while
    a lane up to the nearest stop waits on a word that is not ready
    (another epoch's, or not yet written) and returns ``(prefix,
    windows)``: the combined (head, w, c) of the tiles before ``tile`` back
    to the nearest inclusive prefix or run head, and the number of 32-word
    windows it read."""
    acc = (0, 0, -1)
    pred, windows = tile - 1, 0
    while True:
        windows += 1
        words = [None] * 32          # (stop, (head, w, c)) once ready
        while True:                  # each lane polls its own word
            for lane in range(32):
                j = pred - lane
                if words[lane] is None and j < 0:
                    words[lane] = (True, (0, 0, -1))   # an empty prefix
                elif words[lane] is None:
                    flag, head, ww, c, ep = spr.unpack_status(status[j])
                    if ep == epoch and flag != 0:
                        words[lane] = (flag == spr.FLAG_PREFIX or head == 1,
                                       (head, ww, c))
            stop = [w is not None and w[0] for w in words]
            c = stop.index(True) if any(stop) else 32
            if all(w is not None for w in words[:c + 1]):
                break
            yield
        v = [words[lane][1] if lane <= c else (0, 0, -1)
             for lane in range(32)]
        off = 1                      # the ordered shuffle-down reduction
        while off < 32:
            v = [seg_of(_py_combine(v[lane + off], v[lane]))
                 if lane + off < 32 else v[lane] for lane in range(32)]
            off *= 2
        acc = seg_of(_py_combine(v[0], acc))
        if any(stop):
            return acc, windows
        pred -= 32


def scan_probe_lookback_emulation(keys, setcode, writer, e_init, threads,
                                  per_thread, rng, resident=8):
    """``csrc/scan_probe.cu`` in plain PyTorch: each tile's local scan (the
    kernel's thread-serial fold, warp shuffle scan and block combine), then
    the blocks interleaved at random -- tickets handed out in start order,
    at most ``resident`` blocks at once, every step of a random block --
    over status words left by an earlier call, and the apply.  Returns
    ``(e_before, waits, windows)`` with the look-back windows of each tile
    that looked back."""
    n = keys.shape[0]
    tile = threads * per_thread
    n_tiles = -(-n // tile)
    k = _tiles(torch.from_numpy(keys.astype(np.int64)), n_tiles, threads,
               per_thread, 0)
    i = torch.arange(n_tiles * tile).view(k.shape)
    valid = i < n
    sc = _tiles(torch.from_numpy(setcode.astype(np.int64)), n_tiles, threads,
                per_thread, -1)
    wr = _tiles(torch.from_numpy(writer.astype(np.int64)), n_tiles, threads,
                per_thread, 0)
    ei = _tiles(torch.from_numpy(e_init.astype(np.int64)), n_tiles, threads,
                per_thread, 0)
    flat = k.reshape(-1)
    kp = torch.cat([flat[:1], flat[:-1]]).view(k.shape)   # halo included
    head = ((i == 0) | (kp != k)).to(torch.int64)
    lane_seg = (head, wr, torch.where(sc >= 0, sc & 1, -1))
    # thread-serial fold over the thread's valid lanes
    agg = _seg_identity(k.shape[:2])
    for j in range(per_thread):
        x = tuple(torch.where(valid[..., j], s[..., j], e)
                  for s, e in zip(lane_seg, _seg_identity(k.shape[:2])))
        agg = _seg_combine(agg, x)
    # warp inclusive scan by shuffles, block combine over the warps
    wshape = (n_tiles, threads // 32, 32)
    lane = torch.arange(32)
    incl = tuple(x.reshape(wshape) for x in agg)
    for off in (1, 2, 4, 8, 16):
        o = tuple(torch.cat([e[..., :off], x[..., :-off]], -1)
                  for x, e in zip(incl, _seg_identity(wshape)))
        incl = tuple(torch.where(lane >= off, c, x)
                     for c, x in zip(_seg_combine(o, incl), incl))
    excl = tuple(torch.cat([e[..., :1], x[..., :-1]], -1)
                 for x, e in zip(incl, _seg_identity(wshape)))
    warp_tot = tuple(x[..., 31] for x in incl)
    pre = _seg_identity((n_tiles,))
    pres = []
    for w in range(threads // 32):
        pres.append(pre)
        pre = _seg_combine(pre, tuple(x[:, w] for x in warp_tot))
    total = pre
    pre_w = tuple(torch.stack([p[f] for p in pres], 1) for f in range(3))
    thread_excl = _seg_combine(tuple(x[..., None] for x in pre_w), excl)
    thread_excl = tuple(x.reshape(n_tiles, threads) for x in thread_excl)
    continues = [t > 0 and int(flat[t * tile - 1]) == int(flat[t * tile])
                 for t in range(n_tiles)]

    # status words left by an earlier call (older epoch), then the blocks
    epoch = 5
    status = [spr.pack_status(int(rng.integers(1, 3)), int(rng.integers(0, 2)),
                              int(rng.integers(0, 100)),
                              int(rng.integers(-1, 2)), epoch - 1)
              for _ in range(n_tiles)]
    prefix = [None] * n_tiles
    windows = {}

    def block(ticket):
        tot = seg_of(x[ticket] for x in total)
        status[ticket] = spr.pack_status(
            spr.FLAG_PREFIX if tot[0] else spr.FLAG_AGGREGATE, *tot, epoch)
        yield
        if continues[ticket]:
            before, windows[ticket] = yield from look_back(status, ticket,
                                                           epoch)
            prefix[ticket] = before
            if not tot[0]:
                status[ticket] = spr.pack_status(
                    spr.FLAG_PREFIX, *seg_of(_py_combine(before, tot)), epoch)

    next_ticket, active, steps = 0, [], 0
    while next_ticket < n_tiles or active:
        steps += 1
        assert steps < 100 * n_tiles + 10_000, "the blocks made no progress"
        if next_ticket < n_tiles and (not active or (
                len(active) < resident and rng.random() < 0.5)):
            active.append(block(next_ticket))
            next_ticket += 1
            continue
        g = active[int(rng.integers(len(active)))]
        try:
            next(g)
        except StopIteration:
            active.remove(g)

    # apply the exclusive prefix lane by lane
    tp = tuple(torch.tensor([(p if p is not None else (0, 0, -1))[f]
                             for p in prefix]) for f in range(3))
    use = torch.tensor(continues)[:, None]
    run = tuple(torch.where(use, c, x) for c, x in
                zip(_seg_combine(tuple(x[:, None] for x in tp), thread_excl),
                    thread_excl))
    e_before = torch.zeros(k.shape, dtype=torch.bool)
    waits = torch.zeros(k.shape, dtype=torch.int32)
    for j in range(per_thread):
        h = head[..., j] == 1
        waits[..., j] = torch.where(h, 0, run[1]).to(torch.int32)
        e_before[..., j] = torch.where(h, ei[..., j] == 1, torch.where(
            run[2] >= 0, run[2] == 1, ei[..., j] == 1))
        run = _seg_combine(run, tuple(s[..., j] for s in lane_seg))
    return e_before.reshape(-1)[:n], waits.reshape(-1)[:n], windows


def _probe_inputs(layout, n, seed):
    rng = np.random.default_rng(seed)
    return (sweep_keys(layout, n, seed), rng.integers(-1, 2, n).astype(
        np.int32), rng.random(n) < 0.3, rng.random(n) < 0.5)


def _check_probe(args, got, pallas_block=1024):
    eb, wt = (x.numpy() for x in got[:2])
    jargs = [jnp.asarray(x) for x in args]
    for want in (j_scan_probe_ref(*jargs),
                 scan_probe_op(*jargs, block=pallas_block, interpret=True),
                 spr.scan_probe_ref(*(torch.as_tensor(x) for x in args))):
        we, ww = (np.asarray(x) for x in want)
        assert np.array_equal(eb, we)
        assert wt.dtype == ww.dtype and np.array_equal(wt, ww)


@pytest.mark.parametrize("n", tile_edges(sp.TILE))
@pytest.mark.parametrize("layout", SWEEP_LAYOUTS)
def test_scan_probe_lookback_equals_reference(layout, n):
    """The kernel's own tile (128 threads x 4 lanes), blocks interleaved
    at random over stale status words, at every tile edge."""
    args = _probe_inputs(layout, n, seed=n)
    got = scan_probe_lookback_emulation(*args, sp.THREADS, sp.PER_THREAD,
                                        np.random.default_rng(n))
    _check_probe(args, got)
    if layout == "one_run":
        assert sorted(got[2]) == list(range(1, -(-n // sp.TILE)))


@pytest.mark.parametrize("n", tile_edges(128) + [5200])
@pytest.mark.parametrize("layout", SWEEP_LAYOUTS)
def test_scan_probe_small_tiles_lookback_equals_reference(layout, n):
    """32 threads x 4 lanes a tile, so one run crosses up to 41 tiles and a
    look-back may read a second window of 32 words."""
    args = _probe_inputs(layout, n, seed=n + 3)
    got = scan_probe_lookback_emulation(*args, 32, 4,
                                        np.random.default_rng(n + 4),
                                        resident=5)
    _check_probe(args, got, pallas_block=256)


def _agg(head, w, c, epoch=3):
    return spr.pack_status(spr.FLAG_AGGREGATE, head, w, c, epoch)


def _run(gen):
    try:
        while True:
            next(gen)
    except StopIteration as stop:
        return stop.value


def test_look_back_stops_at_a_run_head_aggregate():
    """An aggregate with head = 1 cuts the segment: the look-back stops
    there, in its first window, and what lies before it does not count."""
    status = [_agg(0, 9, 1)] * 40
    status[30] = _agg(1, 2, 0)       # a head in tile 30
    status[31:] = [_agg(0, 1, -1)] * 9
    (head, w, c), windows = _run(look_back(status, 38, 3))
    assert (head, w, c, windows) == (1, 2 + 7, 0, 1)


def test_look_back_stops_at_an_inclusive_prefix():
    status = [_agg(0, 1, 0)] * 40
    status[20] = spr.pack_status(spr.FLAG_PREFIX, 0, 100, 1, 3)
    status[25] = _agg(0, 1, -1)
    (head, w, c), windows = _run(look_back(status, 30, 3))
    assert (head, w, c, windows) == (0, 100 + 9, 0, 1)


def test_look_back_crosses_windows_to_tile_zero():
    """No prefix and no head for 39 tiles: two windows, back to tile 0."""
    status = [spr.pack_status(spr.FLAG_PREFIX, 1, 1, -1, 3)]
    status += [_agg(0, 1, -1)] * 39
    status[5] = _agg(0, 1, 1)
    (head, w, c), windows = _run(look_back(status, 40, 3))
    assert (head, w, c, windows) == (1, 40, 1, 2)


def test_look_back_waits_for_words_of_this_epoch():
    """A word of another epoch reads as not ready: the warp spins until
    the tile publishes."""
    status = [spr.pack_status(spr.FLAG_PREFIX, 1, 0, 0, 3),
              _agg(0, 4, 1, epoch=2)]
    gen = look_back(status, 2, 3)
    for _ in range(3):
        next(gen)                      # tile 1 has not published yet
    status[1] = _agg(0, 1, -1, epoch=3)
    assert _run(gen) == ((1, 1, 0), 1)


def test_look_back_waits_only_up_to_the_nearest_stop():
    """Words beyond the nearest prefix are not waited on, even when they
    are not ready: the look-back ends at its first poll."""
    status = [_agg(0, 1, 0, epoch=2)] * 10      # tiles 0-7: stale
    status[8] = spr.pack_status(spr.FLAG_PREFIX, 0, 5, 1, 3)
    status[9] = _agg(0, 2, -1)
    with pytest.raises(StopIteration) as stop:
        next(look_back(status, 10, 3))
    assert stop.value.value == ((0, 7, 1), 1)


@pytest.mark.parametrize("flag", [spr.FLAG_AGGREGATE, spr.FLAG_PREFIX])
@pytest.mark.parametrize("head", [0, 1])
@pytest.mark.parametrize("c", [-1, 0, 1])
@pytest.mark.parametrize("w,epoch", [(0, 1), (2048, 2**27),
                                     (2**31 - 1, spr.EPOCH_MAX)])
def test_status_word_round_trip(flag, head, c, w, epoch):
    word = spr.pack_status(flag, head, w, c, epoch)
    assert 0 <= word < 2**64
    assert spr.unpack_status(word) == (flag, head, w, c, epoch)
    # as the int64 scratch holds it
    signed = word - 2**64 if word >= 2**63 else word
    assert spr.unpack_status(signed) == (flag, head, w, c, epoch)
    t = torch.tensor([signed], dtype=torch.int64)
    assert spr.unpack_status(int(t[0])) == (flag, head, w, c, epoch)


@pytest.mark.parametrize("bad", [dict(w=2**31), dict(c=2), dict(epoch=0),
                                 dict(epoch=2**28), dict(flag=0)])
def test_status_word_refuses_what_it_cannot_hold(bad):
    kw = dict(flag=1, head=0, w=0, c=0, epoch=1) | bad
    with pytest.raises(ValueError):
        spr.pack_status(**kw)


def test_scratch_epoch_wraps_through_zero():
    """At the wrap the words and the ticket counter are zeroed before epoch
    1 comes back, so no word of the earlier cycle reads as ready."""
    s = sp.Scratch(torch.device("cpu"), 4)
    s.buf[:] = 7
    s.epoch = spr.EPOCH_MAX - 1
    assert s.next_epoch() == spr.EPOCH_MAX
    assert int(s.buf[1]) == 7
    assert s.next_epoch() == 1
    assert int(s.buf.abs().sum()) == 0
    assert spr.unpack_status(int(s.buf[1]))[0] == 0       # not ready


def test_scratch_is_cached_and_grows_zeroed():
    cpu = torch.device("cpu")
    key = (cpu.index, -12345)
    try:
        a = sp.scratch_of(cpu, -12345, 3)
        assert a.tiles == sp.MIN_TILES and a is sp.scratch_of(cpu, -12345, 64)
        a.buf[:] = 1
        a.epoch = 4
        b = sp.scratch_of(cpu, -12345, 65)
        assert b is not a and b.tiles == 2 * sp.MIN_TILES
        assert int(b.buf.abs().sum()) == 0 and b.epoch == 0
        assert sp.scratch_of(cpu, -12345, 600).tiles == 600
    finally:
        sp._SCRATCH.pop(key, None)


def test_tensor_core_head_dims_match_the_sources():
    """The head dims at which bf16 runs the tensor-core kernels, forward
    and backward, are ``ops.py``'s two sets; each source dispatches on its
    own; only D 80, 96 and 112 are not whole boxes (both directions read
    D 80's and 96's tail box, and D 112's second box past the row as
    zeros), and both directions run every D on the tensor cores."""
    src = (build.CSRC / "attention_common.cuh").read_text()

    def dims(name):
        body = re.search(rf"constexpr bool {name} =([^;]*);", src)[1]
        return tuple(int(x) for x in re.findall(r"D == (\d+)", body))

    assert dims("kTensorCoresFwd") == fa.FWD_TENSOR_CORE_DIMS
    assert dims("kTensorCoresBwd") == fa.BWD_TENSOR_CORE_DIMS
    assert set(fa.BWD_TENSOR_CORE_DIMS) <= set(fa.FWD_TENSOR_CORE_DIMS) \
        <= set(fa.INSTANCES)
    fwd = (build.CSRC / "flash_attention.cu").read_text()
    bwd = (build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "kTensorCoresFwd<" in fwd and "kTensorCoresBwd" not in fwd
    assert "kTensorCoresBwd<" in bwd and "kTensorCoresFwd" not in bwd
    assert [d for d in fa.FWD_TENSOR_CORE_DIMS if padded_width(d) != d] == \
        [80, 96, 112]
    assert [d for d in fa.BWD_TENSOR_CORE_DIMS if padded_width(d) != d] == \
        [80, 96, 112]
    assert set(fa.FWD_TENSOR_CORE_DIMS) == set(fa.BWD_TENSOR_CORE_DIMS)
    for text in (fwd, bwd):     # one copy of the tail-box machinery
        assert "struct Cols" not in text and "Cols<D>" in text
    assert "struct Cols" in src


def _switch_cases(src: str, macro: str) -> tuple[int, ...]:
    """The widths a launcher's ``switch`` dispatches on: the arguments of
    every use of ``macro`` (``FLASH_CASE(32)`` ...) in ``src``."""
    return tuple(int(x) for x in re.findall(rf"^\s*{macro}\((\d+)\)", src,
                                            re.M))


def test_instances_match_the_launchers():
    """``INSTANCES`` of each ``ops.py`` are the widths its C launcher
    dispatches on and answers shared memory for (the forward and the
    backward share theirs; paged dispatches on them twice: its split
    kernel at a compiled head dim, its column-pass kernel at any other)."""
    fwd = (build.CSRC / "flash_attention.cu").read_text()
    bwd = (build.CSRC / "flash_attention_bwd.cu").read_text()
    paged = (build.CSRC / "paged_attention.cu").read_text()
    assert _switch_cases(fwd, "FLASH_CASE") == fa.INSTANCES
    assert _switch_cases(fwd, "FLASH_SMEM") == fa.INSTANCES
    assert _switch_cases(bwd, "BWD_CASE") == fa.INSTANCES
    assert _switch_cases(bwd, "BWD_SMEM") == fa.INSTANCES
    assert _switch_cases(paged, "PAGED_CASE") == pa.INSTANCES
    assert _switch_cases(paged, "COLS_CASE") == pa.INSTANCES
    assert _switch_cases(paged, "PAGED_SMEM") == pa.INSTANCES
    assert set(fa.INSTANCES) == set(fa.FWD_TENSOR_CORE_DIMS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ops", [fa, pa], ids=["flash", "paged"])
def test_instance_of_every_head_dim(ops, dtype):
    """Every head dim 1-1,024 has a plan: the width it runs at is D, or in
    flash D rounded up to whole 16-byte chunks where a row is not whole
    chunks (padded: a multiple of 8 in bf16, of 4 in f32; paged loads
    such rows itself, never padded); up to 256 the smallest instance at or
    above that width in one pass, past it the 256 instance in ceil(width /
    256) column passes.  Each instance, and so every published head dim,
    is its own plan: unpadded, one pass."""
    chunk = 16 // dtype.itemsize
    for d in range(1, 1025):
        plan = ops.plan_of(d, dtype)
        padded = ops is fa and d % chunk != 0
        width = -(-d // chunk) * chunk if padded else d
        if width <= 256:
            want = (d, min(x for x in ops.INSTANCES if x >= width), 1, padded)
        else:
            want = (d, 256, -(-width // 256), padded)
        assert plan == want, (d, plan, want)
        assert ops.instance_of(d, dtype) == plan.w
    for w in ops.INSTANCES:
        assert ops.plan_of(w, dtype) == (w, w, 1, False)
    assert ops.instance_of(80, dtype) == (80 if ops is fa else 96)
    with pytest.raises(ValueError, match="head dim 0"):
        ops.plan_of(0, dtype)


# head dims between the instances (B, H, KH, S, D, causal, window):
# recurrentgemma-9b's smoke MQA at D 16 with its 16-token window, and D
# 48, 72 and 200, which run on the 64-, 80- and 256-column instances
ANY_D_CASES = [
    (1, 4, 1, 256, 16, True, 16),
    (1, 4, 1, 200, 16, False, 0),
    (1, 4, 2, 300, 48, True, 0),
    (1, 4, 4, 256, 72, False, 0),
    (1, 4, 1, 256, 200, True, 64),
]


@pytest.mark.parametrize("b,h,kh,s,d,causal,window", ANY_D_CASES)
def test_flash_any_head_dim_on_its_instance_within_two_ulps(b, h, kh, s, d,
                                                            causal, window):
    """The bf16 forward at a head dim between the instances, emulated on
    its instance's tiles (the columns past D zeros, as TMA fills them, the
    output cut back to D), stays within two bf16 ulps of the port's and
    the JAX package's references, and gives the bits of the same
    arithmetic at the true width: the zero columns add exact zeros."""
    rng = np.random.default_rng(d)
    (qj, qt), (kj, kt), (vj, vt) = (_bf16(rng, x) for x in (
        (b, h, s, d), (b, kh, s, d), (b, kh, s, d)))
    kw = dict(causal=causal, window=window)
    w = fa.instance_of(d, torch.bfloat16)
    assert w > d
    got = flash_tensor_core_emulation(qt, kt, vt, split_p=True, width=w, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    assert _beyond_two_ulps(got, flash_attention_ref(qt, kt, vt, **kw)) == 0
    want_j = torch.from_numpy(np.array(j_flash_ref(
        qj, kj, vj, **kw).astype(jnp.float32)))
    assert _beyond_two_ulps(got, want_j) == 0
    assert torch.equal(got, flash_tensor_core_emulation(
        qt, kt, vt, split_p=True, **kw))


@pytest.mark.parametrize("b,h,kh,s,d,causal,window", ANY_D_CASES)
def test_flash_bwd_any_head_dim_on_its_instance_within_tolerance(
        b, h, kh, s, d, causal, window):
    """The bf16 backward at those head dims, emulated on the instance's
    tiles (delta over the D columns, every product over zero columns to
    the instance's width, the gradients cut back to D), has no element
    beyond ``BWD_TOL`` of the port's plain backward fed the same f32
    output, nor of ``jax.vjp`` of the reference's ``gqa_attention``; at
    W 256 with the dK/dV pass split over the head groups the launcher
    picks on 132 SMs as well."""
    rng = np.random.default_rng(d + 1)
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (_bf16(rng, x) for x in (
        (b, h, s, d), (b, kh, s, d), (b, kh, s, d), (b, h, s, d)))
    kw = dict(causal=causal, window=window)
    w = fa.instance_of(d, torch.bfloat16)
    _, lse, out32 = flash_attention_ref(qt, kt, vt, return_lse=True, **kw)
    out = flash_tensor_core_emulation(qt, kt, vt, split_p=True, f32_out=True,
                                      width=w, **kw)
    want_t = flash_attention_bwd_ref(qt, kt, vt, out32, dot, lse, **kw)
    j32 = [x.astype(jnp.float32).transpose(0, 2, 1, 3)
           for x in (qj, kj, vj, doj)]
    _, vjp = jax.vjp(lambda q_, k_, v_: jatt.gqa_attention(
        q_, k_, v_, chunk=s, **kw), *j32[:3])
    want_j = [torch.from_numpy(np.array(x)).transpose(1, 2)
              for x in vjp(j32[3])]
    groups = ((1, fa.bwd_head_groups(b, kh, h // kh, s, 132))
              if w in fa.BWD_GROUPED_DIMS else (1,))
    for n in groups:
        got = flash_bwd_tensor_core_emulation(
            qt, kt, vt, out, dot, lse, split_p=True, split_ds=True, width=w,
            n_groups=n, **kw)
        for x, wt, wj in zip(got, want_t, want_j):
            assert x.dtype == torch.bfloat16 and x.shape == wt.shape
            assert _beyond_bwd_tol(x, wt) == 0
            assert _beyond_bwd_tol(x, wj) == 0


@pytest.mark.parametrize("b,kh,g,s,fill,want", [
    (1, 1, 16, 4096, 132, 4),    # recurrentgemma's training shape: 64 -> 256
    (1, 4, 1, 320, 132, 1),      # g 1: nothing to split
    (1, 4, 4, 130, 132, 4),      # 3 key tiles: every head a group of its own
    (2, 4, 2, 1100, 132, 1),     # 144 blocks fill the card unsplit
    (1, 1, 6, 1024, 40, 3)])     # the fewest groups that fill, a divisor
def test_bwd_head_groups_fill_the_card(b, kh, g, s, fill, want):
    """The grouped dK/dV pass (D 256, 64-key blocks) splits a kv head's
    query heads over the fewest groups, a divisor of g, that give the grid
    ``fill`` blocks, or over g groups; ``paged_attention``'s rule."""
    n = fa.bwd_head_groups(b, kh, g, s, fill)
    assert n == want and g % n == 0
    blocks = b * kh * -(-s // 64)
    assert blocks * n >= fill or n == g
    assert all(blocks * m < fill for m in range(1, n) if g % m == 0)


@pytest.mark.parametrize("name,mod", [("wc_combine", wcc), ("scan_probe", sp)])
def test_sweep_tile_constants_match_the_sources(name, mod):
    src = (build.CSRC / f"{name}.cu").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", src)[1]) == \
        mod.THREADS
    assert int(re.search(r"constexpr int kPerThread = (\d+);", src)[1]) == \
        mod.PER_THREAD
    assert mod.TILE == mod.THREADS * mod.PER_THREAD
    if name == "scan_probe":
        assert int(re.search(r"constexpr int kEpochShift = (\d+);", src)[1]) \
            == spr.EPOCH_SHIFT
        assert int(re.search(r"kFlagAggregate = (\d+);", src)[1]) == \
            spr.FLAG_AGGREGATE
        assert int(re.search(r"kFlagPrefix = (\d+);", src)[1]) == \
            spr.FLAG_PREFIX


# ---------------------------------------------------------------------------
# head dims past 256 (column passes) and rows not whole 16-byte chunks
# ---------------------------------------------------------------------------

COLS = 256      # the column-pass kernels' score chunk and output pass


def _over_chunks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b^T summed over the shared axis in chunks of ``COLS`` columns, in
    order: the column-pass kernels' S and dP, each chunk staged and its
    products added to the running sums in registers."""
    out = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for c0 in range(0, a.shape[-1], COLS):
        out = out + a[..., c0:c0 + COLS] @ b[..., c0:c0 + COLS].transpose(
            -1, -2)
    return out


def _passes(d: int, passes: int) -> list[slice]:
    """The output columns of each of ``passes`` column passes (one pass:
    every column, the arithmetic at the true width)."""
    return ([slice(0, d)] if passes == 1 else
            [slice(c0, min(c0 + COLS, d)) for c0 in range(0, d, COLS)])


def _mask(s: int, causal: bool, window: int) -> torch.Tensor:
    pos = torch.arange(s)
    ok = torch.ones((s, s), dtype=torch.bool)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window:
        ok &= pos[None, :] > pos[:, None] - window
    return ok


def flash_cols_emulation(q, k, v, *, causal, window, passes, block_k=64):
    """The column-pass forward (``flash_fwd_cols``: f32 on the CUDA cores,
    either dtype) in plain PyTorch: q pre-scaled by D^-1/2; S = Q K^T over
    chunks of 256 columns (``_over_chunks``); the reference's masks; (m,
    l, acc) over 64-key tiles with exp; each of ``passes`` passes
    recomputes S, m and l and accumulates its own output columns.  Returns
    (out in q's dtype, the f32 output, lse of pass 0, each pass's (m,
    l))."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    qf = q.float() * d ** -0.5
    kf, vf = (x.repeat_interleave(g, 1).float() for x in (k, v))
    ok = _mask(s, causal, window)
    outs, stats = [], []
    for cols in _passes(d, passes):
        m = torch.full((b, h, s), NEG_INF)
        l_ = torch.zeros((b, h, s))
        acc = torch.zeros((b, h, s, cols.stop - cols.start))
        for k0 in range(0, s, block_k):
            ks = slice(k0, min(k0 + block_k, s))
            sc = torch.where(ok[:, ks], _over_chunks(qf, kf[:, :, ks]),
                             NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l_ = l_ * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vf[:, :, ks, cols]
            m = m_new
        outs.append(acc / l_.clamp(min=1e-30)[..., None])
        stats.append((m, l_))
    out32 = torch.cat(outs, -1)
    lse = stats[0][0] + torch.log(stats[0][1].clamp(min=1e-30))
    return out32.to(q.dtype), out32, lse, stats


def flash_bwd_cols_emulation(q, k, v, out, dout, lse, *, causal, window,
                             passes):
    """The column-pass backward (``flash_bwd_dkdv_cols``,
    ``flash_bwd_dq_cols``) in plain PyTorch: delta = rowsum(dout * out)
    over the D columns; S and dP over chunks of 256 columns; P = exp(S
    scale - lse) under the masks, dS = P (dP - delta), in f32; each pass
    accumulates its own columns -- dK and dV of a kv head over 32-row
    query tiles and, inside each, its g query heads; dQ over 64-key tiles
    -- and recomputes S and dP for them; dK and dQ scaled at the store,
    every gradient rounded once to q's dtype."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    scale = d ** -0.5
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    delta = (dof * out.float()).sum(-1)
    ok = _mask(s, causal, window)

    def p_ds(hh, qs, ks):
        sc = _over_chunks(qf[:, hh, qs], kf[:, hh // g, ks])
        p = torch.where(ok[qs, ks], torch.exp(sc * scale - lse[:, hh, qs,
                                                                None]), 0.0)
        dp = _over_chunks(dof[:, hh, qs], vf[:, hh // g, ks])
        return p, p * (dp - delta[:, hh, qs, None])

    dq = torch.zeros((b, h, s, d))
    dk = torch.zeros((b, kh, s, d))
    dv = torch.zeros((b, kh, s, d))
    for cols in _passes(d, passes):
        for q0 in range(0, s, 32):
            qs = slice(q0, min(q0 + 32, s))
            for hh in range(h):
                p, ds = p_ds(hh, qs, slice(0, s))
                dv[:, hh // g, :, cols] += p.transpose(-1, -2) @ \
                    dof[:, hh, qs, cols]
                dk[:, hh // g, :, cols] += ds.transpose(-1, -2) @ \
                    qf[:, hh, qs, cols]
        for k0 in range(0, s, 64):
            ks = slice(k0, min(k0 + 64, s))
            for hh in range(h):
                _, ds = p_ds(hh, slice(0, s), ks)
                dq[:, hh, :, cols] += ds @ kf[:, hh // g, ks, cols]
    return tuple(x.to(q.dtype) for x in (dq * scale, dk * scale, dv))


# (B, H, KH, S, D, causal, window, dtype): D 264 (a 256-column pass and an
# 8-column one) and 512 (two whole passes), in both dtypes
COLS_CASES = [
    (1, 4, 2, 160, 264, True, 64, torch.bfloat16),
    (1, 4, 1, 130, 264, False, 0, torch.float32),
    (1, 2, 2, 128, 512, True, 0, torch.float32),
    (1, 4, 2, 96, 512, False, 48, torch.bfloat16),
]


def _inputs(rng, dtype, *shapes):
    """Seeded normal values in ``dtype``, as JAX f32 arrays and CPU
    tensors with the same values."""
    out = []
    for shape in shapes:
        t = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
        out.append((jnp.asarray(t.float().numpy()), t))
    return out


@pytest.mark.parametrize("b,h,kh,s,d,causal,window,dtype", COLS_CASES)
def test_flash_column_passes_within_two_ulps(b, h, kh, s, d, causal, window,
                                             dtype):
    """The forward past 256: the column passes' output within two bf16
    ulps (f32: 2e-5) of the port's and the JAX package's references, lse
    within 1e-5; every pass's m and l the same bits (each recomputes S in
    the same chunks and order, so the output's columns share one
    normalization and lse is written once); and the passes' columns the
    bits of the same arithmetic in one pass over the whole row."""
    rng = np.random.default_rng(d + s)
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        rng, dtype, (b, h, s, d), (b, kh, s, d), (b, kh, s, d))
    kw = dict(causal=causal, window=window)
    passes = fa.plan_of(d, dtype).passes
    assert passes == -(-d // 256) >= 2
    got, out32, lse, stats = flash_cols_emulation(qt, kt, vt, passes=passes,
                                                  **kw)
    for m, l_ in stats[1:]:
        assert torch.equal(m, stats[0][0]) and torch.equal(l_, stats[0][1])
    whole = flash_cols_emulation(qt, kt, vt, passes=1, **kw)
    assert torch.equal(out32, whole[1])
    want, want_lse, _ = flash_attention_ref(qt, kt, vt, return_lse=True, **kw)
    want_j = torch.from_numpy(np.array(j_flash_ref(qj, kj, vj, **kw)))
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    for w in (want, want_j):
        if dtype == torch.bfloat16:
            assert _beyond_two_ulps(got, w) == 0
        else:
            torch.testing.assert_close(got, w.float(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,h,kh,s,d,causal,window,dtype", COLS_CASES)
def test_flash_bwd_column_passes_within_tolerance(b, h, kh, s, d, causal,
                                                  window, dtype):
    """The backward past 256: the column passes' dq, dk, dv have no
    element beyond ``BWD_TOL`` (f32: 1e-4) of the port's plain backward
    fed the same f32 output and of ``jax.vjp`` of the reference's
    ``gqa_attention``, and are the bits of the same arithmetic in one pass
    (each pass recomputes S and dP over the whole row in the same chunks,
    and no block sums another's columns: no atomics)."""
    rng = np.random.default_rng(d + s + 1)
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _inputs(
        rng, dtype, (b, h, s, d), (b, kh, s, d), (b, kh, s, d), (b, h, s, d))
    kw = dict(causal=causal, window=window)
    passes = fa.plan_of(d, dtype).passes
    _, out32, lse, _ = flash_cols_emulation(qt, kt, vt, passes=passes, **kw)
    got = flash_bwd_cols_emulation(qt, kt, vt, out32, dot, lse,
                                   passes=passes, **kw)
    whole = flash_bwd_cols_emulation(qt, kt, vt, out32, dot, lse, passes=1,
                                     **kw)
    for x, y in zip(got, whole):
        assert torch.equal(x, y)
    want_t = flash_attention_bwd_ref(qt, kt, vt, out32, dot, lse, **kw)
    j32 = [x.transpose(0, 2, 1, 3) for x in (qj, kj, vj, doj)]
    _, vjp = jax.vjp(lambda q_, k_, v_: jatt.gqa_attention(
        q_, k_, v_, chunk=s, **kw), *j32[:3])
    want_j = [torch.from_numpy(np.array(x)).transpose(1, 2)
              for x in vjp(j32[3])]
    for x, wt, wj in zip(got, want_t, want_j):
        assert x.dtype == dtype and x.shape == wt.shape
        for w in (wt, wj):
            if dtype == torch.bfloat16:
                assert _beyond_bwd_tol(x, w) == 0
            else:
                torch.testing.assert_close(x, w.float(), rtol=1e-4,
                                           atol=1e-4)


def test_flash_padded_copy_plan_at_d20():
    """D 20 in bf16 (a 40-byte row, which no tensor map describes): the
    plan runs both directions on dense copies 24 columns wide (zeros past
    column 19) on the 32-column tensor-core instances, TMA filling
    columns 24-31 with zeros too.  Emulated on the instance's tiles, the
    forward stays within two bf16 ulps of both references and the
    backward within ``BWD_TOL``, and both are the bits of the same
    arithmetic at the true width: the zero columns add exact zeros and the
    scale stays 20^-1/2."""
    b, h, kh, s, d = 1, 4, 2, 192, 20
    plan = fa.plan_of(d, torch.bfloat16)
    assert plan == (20, 32, 1, True)
    assert build.padded_width(d, torch.bfloat16) == 24
    rng = np.random.default_rng(20)
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (_bf16(rng, x) for x in (
        (b, h, s, d), (b, kh, s, d), (b, kh, s, d), (b, h, s, d)))
    kw = dict(causal=True, window=48)
    got = flash_tensor_core_emulation(qt, kt, vt, split_p=True,
                                      width=plan.w, **kw)
    assert torch.equal(got, flash_tensor_core_emulation(
        qt, kt, vt, split_p=True, **kw))
    assert _beyond_two_ulps(got, flash_attention_ref(qt, kt, vt, **kw)) == 0
    assert _beyond_two_ulps(got, torch.from_numpy(np.array(j_flash_ref(
        qj, kj, vj, **kw).astype(jnp.float32)))) == 0
    _, lse, out32 = flash_attention_ref(qt, kt, vt, return_lse=True, **kw)
    out = flash_tensor_core_emulation(qt, kt, vt, split_p=True, f32_out=True,
                                      width=plan.w, **kw)
    grads = flash_bwd_tensor_core_emulation(
        qt, kt, vt, out, dot, lse, split_p=True, split_ds=True, width=plan.w,
        **kw)
    true_width = flash_bwd_tensor_core_emulation(
        qt, kt, vt, out, dot, lse, split_p=True, split_ds=True, **kw)
    want_t = flash_attention_bwd_ref(qt, kt, vt, out32, dot, lse, **kw)
    j32 = [x.astype(jnp.float32).transpose(0, 2, 1, 3)
           for x in (qj, kj, vj, doj)]
    _, vjp = jax.vjp(lambda q_, k_, v_: jatt.gqa_attention(
        q_, k_, v_, chunk=s, **kw), *j32[:3])
    want_j = [torch.from_numpy(np.array(x)).transpose(1, 2)
              for x in vjp(j32[3])]
    for x, y, wt, wj in zip(grads, true_width, want_t, want_j):
        assert torch.equal(x, y)
        assert _beyond_bwd_tol(x, wt) == 0 and _beyond_bwd_tol(x, wj) == 0


def paged_cols_emulation(q, k_pages, v_pages, block_table, lengths, split):
    """The column-pass paged kernel (``paged_cols_kernel``, one head
    group) in plain PyTorch, f32: a block per (kv head, column pass,
    sequence, split) scores its positions over chunks of 256 columns
    (``_over_chunks``), keeps (m, l) and its pass's columns of acc; with
    one split it writes them, with more pass 0 writes each split's (m, l)
    and every pass its columns into the (.., D + 2) partials, merged by
    exp(m - max m) as the merge launch does."""
    b, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    g, span = h // kh, block_table.shape[1] * page
    n_split = -(-span // split)
    bt = block_table.long()
    kd = k_pages[bt].reshape(b, span, kh, d).float()
    vd = v_pages[bt].reshape(b, span, kh, d).float()
    qf = q.float() * d ** -0.5
    out = torch.full((b, h, d), float("nan"))
    part = torch.full((b, kh, n_split, g, d + 2), float("nan"))
    for cols in _passes(d, -(-d // COLS)):
        for hk in range(kh):
            for bi in range(b):
                ln = int(lengths[bi])
                n_pos = min(ln, span) if ln >= 1 else span
                for sp in range(n_split):
                    if sp * split >= n_pos:
                        continue
                    pos = torch.arange(sp * split, min(sp * split + split,
                                                       n_pos))
                    sc = _over_chunks(qf[bi, hk * g:(hk + 1) * g],
                                      kd[bi, pos, hk])
                    sc = torch.where(pos < ln, sc, NEG_INF)
                    m = sc.amax(-1)
                    p = torch.exp(sc - m[:, None])
                    acc = p @ vd[bi, pos, hk, cols]
                    if n_split == 1:
                        out[bi, hk * g:(hk + 1) * g, cols] = \
                            acc / p.sum(-1).clamp(min=1e-30)[:, None]
                        continue
                    part[bi, hk, sp, :, cols] = acc
                    if cols.start == 0:
                        part[bi, hk, sp, :, d] = m
                        part[bi, hk, sp, :, d + 1] = p.sum(-1)
    if n_split > 1:
        for bi in range(b):
            ln = int(lengths[bi])
            n_pos = min(ln, span) if ln >= 1 else span
            pb = part[bi, :, :-(-n_pos // split)]
            w = torch.exp(pb[..., d] - pb[..., d].amax(1, keepdim=True))
            den = (pb[..., d + 1] * w).sum(1).clamp(min=1e-30)
            out[bi] = ((pb[..., :d] * w[..., None]).sum(1)
                       / den[..., None]).reshape(h, d)
    return out.to(q.dtype)


@pytest.mark.parametrize("split", [512, 64])
def test_paged_chunked_score_at_d264(split):
    """``paged_attention`` at D 264 (a 256-column chunk and an 8-column
    one, two column passes), f32: the column-pass blocks' chunked scores,
    one launch (split 512 over the 96-row span) and the split-and-merge
    (split 64), against ``paged_attention_ref``, the JAX reference and
    the Pallas kernel in interpret mode, at lengths 0, 1, on a split
    boundary and the full span."""
    assert pa.plan_of(264, torch.float32) == (264, 256, 2, False)
    rng = np.random.default_rng(264 + split)
    (qj, kj, vj), (qt, kt, vt), bt = _paged_case(rng, 4, 4, 2, 264, 16, 6,
                                                 torch.float32)
    ln = np.array([0, 1, 64, 96], np.int32)
    args = (qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(ln))
    got = paged_cols_emulation(*args, split)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, paged_attention_ref(*args), rtol=2e-5,
                               atol=2e-5)
    for want in (paged_attention_op(qj, kj, vj, jnp.asarray(bt),
                                    jnp.asarray(ln), interpret=True),
                 j_paged_ref(qj, kj, vj, jnp.asarray(bt), jnp.asarray(ln))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=2e-5, atol=2e-5)
