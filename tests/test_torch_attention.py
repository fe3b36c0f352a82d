"""The port's attention on the CPU against the JAX reference: the plain
versions of both kernels against ``flash_attention_ref`` /
``paged_attention_ref`` and the Pallas kernels run in interpret mode (the
shape sweeps of ``tests/test_kernels.py``, plus a ragged S and pages that
are not a multiple of the CUDA kernel's 64-position tile), and the model
functions ``gqa_attention`` / ``decode_attention`` against the reference's,
decode also through the identity block table.  Inputs are made with numpy
from a seed and handed to both.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 in f32, 2e-2 in bf16 (3e-2 for paged).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_op, flash_attention_ref as j_flash_ref)
from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention_op, paged_attention_ref as j_paged_ref)
from repro.models import attention as jatt  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as t_flash_ref)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref as t_paged_ref)
from repro_torch.models import attention as tatt  # noqa: E402

# the reference functions, compiled once per shape (eager dispatch of their
# many small ops costs more than the comparison)
j_flash_ref = jax.jit(j_flash_ref, static_argnames=("causal", "window"))
j_paged_ref = jax.jit(j_paged_ref)
j_decode = jax.jit(jatt.decode_attention)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
FLASH_SHAPES = [(2, 4, 2, 256, 64), (1, 8, 8, 128, 128), (2, 4, 1, 256, 64),
                (1, 2, 2, 512, 32)]
MASKS = [(True, 0), (False, 0), (True, 64)]


def _pair(arr: np.ndarray, dt: str):
    """The same values as a JAX array and a CPU tensor of dtype ``dt``
    (bf16 is rounded once, by JAX, and the bits are shared)."""
    jdt, tdt, _ = DTYPES[dt]
    j = jnp.asarray(arr, jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _qkv(rng, b, h, kh, s, d, dt, layout="bhsd"):
    shp = {"bhsd": ((b, h, s, d), (b, kh, s, d)),
           "bshd": ((b, s, h, d), (b, s, kh, d))}[layout]
    return [_pair(rng.standard_normal(x).astype(np.float32), dt)
            for x in (shp[0], shp[1], shp[1])]


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,h,kh,s,d", FLASH_SHAPES)
def test_flash_plain_matches_reference_and_pallas(b, h, kh, s, d, dt, causal,
                                                  window):
    rng = np.random.default_rng(b * 1000 + h * 100 + s)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, b, h, kh, s, d, dt)
    tol = DTYPES[dt][2]
    got = t_flash_ref(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, j_flash_ref(qj, kj, vj, causal=causal, window=window), tol)
    if dt == "f32":     # the Pallas kernel computes in f32 either way
        _close(got, flash_attention_op(qj, kj, vj, causal=causal,
                                       window=window, block_q=64, block_k=64,
                                       interpret=True), tol)


@pytest.mark.parametrize("s", [100, 1000])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_plain_ragged_s(s, causal, window):
    """S not a multiple of any tile (the CUDA kernel's is 64)."""
    rng = np.random.default_rng(s)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, 4, 2, s, 32, "f32")
    got = t_flash_ref(qt, kt, vt, causal=causal, window=window)
    _close(got, j_flash_ref(qj, kj, vj, causal=causal, window=window), 2e-5)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,h,kh,s,d,chunk", [
    (2, 4, 2, 256, 64, 64), (1, 4, 2, 100, 32, 1024)])
def test_gqa_attention_matches_reference(b, h, kh, s, d, chunk, dt, causal,
                                         window):
    """The model's prefill attention, (B, S, H, D) layout; several chunks
    where S > chunk, one ragged chunk where S < chunk."""
    rng = np.random.default_rng(s + d)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, b, h, kh, s, d, dt, "bshd")
    got = tatt.gqa_attention(qt, kt, vt, causal=causal, window=window,
                             chunk=chunk)
    want = jatt.gqa_attention(qj, kj, vj, causal=causal, window=window,
                              chunk=chunk)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, DTYPES[dt][2])
    # and the dense kernel reference in its own (B, H, S, D) layout
    dense = t_flash_ref(qt.transpose(1, 2), kt.transpose(1, 2),
                        vt.transpose(1, 2), causal=causal, window=window)
    _close(got, np.asarray(dense.transpose(1, 2).to(torch.float32)),
           DTYPES[dt][2])


def _paged_inputs(rng, b, h, kh, d, page, np_, dt, extra=4):
    npool = b * np_ + extra
    q = _pair(rng.standard_normal((b, h, d)).astype(np.float32), dt)
    kp = _pair(rng.standard_normal((npool, page, kh, d)).astype(np.float32),
               dt)
    vp = _pair(rng.standard_normal((npool, page, kh, d)).astype(np.float32),
               dt)
    bt = rng.permutation(npool)[: b * np_].reshape(b, np_).astype(np.int32)
    lengths = rng.integers(1, np_ * page + 1, b).astype(np.int32)
    lengths[0] = np_ * page                       # a full sequence
    if b > 1:
        lengths[1] = 1                            # a single position
    return q, kp, vp, bt, lengths


PAGED_SHAPES = [(2, 8, 2, 64, 16, 8), (1, 4, 4, 128, 32, 4),
                (3, 16, 1, 64, 16, 4),
                # the serve shape: the whole 40-token slot as one page
                (1, 16, 8, 128, 40, 1)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,h,kh,d,page,np_", PAGED_SHAPES + [
    # pages that are not a multiple of the CUDA kernel's 64-position tile
    (3, 8, 2, 64, 24, 5), (2, 4, 2, 32, 5, 30)])
def test_paged_plain_matches_reference_and_pallas(b, h, kh, d, page, np_, dt):
    rng = np.random.default_rng(b * 10 + h + page)
    (qj, qt), (kj, kt), (vj, vt), bt, ln = _paged_inputs(rng, b, h, kh, d,
                                                         page, np_, dt)
    tol = 3e-2 if dt == "bf16" else 2e-5
    got = t_paged_ref(qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(ln))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, j_paged_ref(qj, kj, vj, jnp.asarray(bt), jnp.asarray(ln)),
           tol)
    if dt == "f32" and (b, h, kh, d, page, np_) in PAGED_SHAPES:
        _close(got, paged_attention_op(qj, kj, vj, jnp.asarray(bt),
                                       jnp.asarray(ln), interpret=True), tol)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,h,kh,d,smax", [(2, 4, 2, 32, 40), (1, 16, 8, 128, 40),
                                           (3, 8, 1, 64, 100)])
def test_decode_attention_matches_reference_and_identity_table(b, h, kh, d,
                                                               smax, dt):
    rng = np.random.default_rng(smax + h)
    qj, qt = _pair(rng.standard_normal((b, 1, h, d)).astype(np.float32), dt)
    kj, kt = _pair(rng.standard_normal((b, smax, kh, d)).astype(np.float32),
                   dt)
    vj, vt = _pair(rng.standard_normal((b, smax, kh, d)).astype(np.float32),
                   dt)
    tol = DTYPES[dt][2]
    for length in (1, smax // 2 + 1, smax):
        got = tatt.decode_attention(qt, kt, vt, length)
        assert got.dtype == qt.dtype and got.shape == qt.shape
        _close(got, j_decode(qj, kj, vj, length), tol)
        # the dense cache is the page pool of the identity block table
        ident = torch.arange(b, dtype=torch.int32).view(b, 1)
        lens = torch.full((b,), length, dtype=torch.int32)
        paged = t_paged_ref(qt[:, 0], kt, vt, ident, lens)
        _close(got[:, 0], np.asarray(paged.to(torch.float32)), tol)
    # per-sequence lengths as a (B,) tensor
    lens = np.arange(1, b + 1, dtype=np.int32) * (smax // b)
    got = tatt.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    want = np.concatenate([np.asarray(j_decode(
        qj[i:i + 1], kj[i:i + 1], vj[i:i + 1], int(lens[i])), np.float32)
        for i in range(b)])
    _close(got, want, tol)


def test_paged_length_zero_averages_pages_like_reference():
    """A sequence of length 0 is all masked: both versions average every
    row of its pages (the finite -1e30 sentinel, not NaN)."""
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt), bt, ln = _paged_inputs(rng, 2, 4, 2, 32, 16,
                                                         3, "f32")
    ln[:] = 0
    got = t_paged_ref(qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(ln))
    assert torch.isfinite(got).all()
    _close(got, j_paged_ref(qj, kj, vj, jnp.asarray(bt), jnp.asarray(ln)),
           2e-5)
