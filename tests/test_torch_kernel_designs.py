"""The arithmetic of the port's attention kernels, on the CPU, against the
JAX reference, so that it is held to the reference before it runs on a card.

* ``flash_attention`` (bf16, tensor cores): a plain emulation of the
  kernel's arithmetic -- bf16 operands, f32 scores scaled after the product
  in log2 units, an online softmax over 64-key tiles, P split into bf16
  ``hi`` and ``lo = bf16(P - hi)`` with both products summed in f32 -- stays
  within two bf16 ulps (|diff| <= 2^-6 |want| + 1e-5, the check of
  ``chip_smoke.py``) of the port's and the JAX package's
  ``flash_attention_ref``.  The same emulation with one bf16 P does not, on
  the same inputs: that is why the kernel splits P.
* ``paged_attention`` (flash decoding): ``paged_attention_split_ref``, the
  split-and-merge the kernel computes, equals ``paged_attention_ref``, the
  JAX reference and the Pallas kernel in interpret mode, at splits and
  lengths on and around the split boundaries.
* the launcher's split plan: ``split_plan`` sizes the split from the block
  table's span, and one split (the serve's shape) means one launch.
"""
from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as j_flash_ref)
from repro.kernels.paged_attention.ops import paged_attention_op  # noqa: E402
from repro.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref as j_paged_ref)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    NEG_INF, flash_attention_ref)
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref, paged_attention_split_ref)

j_flash_ref = jax.jit(j_flash_ref, static_argnames=("causal", "window"))
j_paged_ref = jax.jit(j_paged_ref)


def _bf16(rng, shape):
    """Seeded normal values rounded once to bf16, as a JAX array and a CPU
    tensor with the same bits."""
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                    jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def flash_tensor_core_emulation(q, k, v, *, causal, window, split_p,
                                block_k=64):
    """The bf16 tensor-core kernel's arithmetic in plain PyTorch: q (B, H,
    S, D), k/v (B, KH, S, D) in bf16; scores in f32 times D^-1/2 log2 e;
    the reference's masks (-1e30); (m, l, acc) in f32 over tiles of
    ``block_k`` keys with exp2; P rounded to bf16 once (``split_p`` False)
    or as hi + lo; the output rounded once to bf16."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, 1).float()
    v = v.repeat_interleave(g, 1).float()
    c = d ** -0.5 * math.log2(math.e)
    m = torch.full((b, h, s), NEG_INF)
    l_ = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    qp = torch.arange(s)[:, None]
    for k0 in range(0, s, block_k):
        kp = torch.arange(k0, min(k0 + block_k, s))[None, :]
        sc = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k[:, :, k0:k0 + block_k]) * c
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
    return (acc / l_.clamp(min=1e-30)[..., None]).to(torch.bfloat16)


def _beyond_two_ulps(got, want) -> int:
    got, want = got.float(), want.float()
    return int(((got - want).abs() > 1e-5 + 2.0 ** -6 * want.abs()).sum())


FLASH_CASES = [
    (1, 4, 4, 2048, 128, True, 0),    # the case the split was chosen on
    (1, 4, 2, 512, 128, True, 0),     # GQA, the model's D
    (1, 4, 2, 512, 64, False, 0),     # no mask
    (1, 4, 2, 512, 32, True, 100),    # a window that ends inside a tile
    (2, 2, 1, 300, 64, False, 100),   # ragged S, window without causality
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
    assert _beyond_two_ulps(split, want_t) == 0
    assert _beyond_two_ulps(split, want_j) == 0
    single = flash_tensor_core_emulation(qt, kt, vt, split_p=False, **kw)
    assert _beyond_two_ulps(single, want_t) > 0
    assert _beyond_two_ulps(single, want_j) > 0


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
