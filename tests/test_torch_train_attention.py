"""The port's attention backward on the CPU against the JAX reference.

``gqa_attention``'s gradients through ``_FlashFn`` (its CPU backward,
``_flash_bwd_plain``, the port of ``_flash_vjp_bwd``) against ``jax.vjp``
of ``repro.models.attention.gqa_attention``, on seeded numpy inputs:
causal, non-causal and a 16-token window, 8 query heads over 2 kv heads,
chunks shorter than S, f32, within rtol 1e-4 / atol 1e-5 (the reference's
own flash test, ``tests/test_archs_smoke.py:131``, takes 1e-4 / 1e-4); ``_flash_bwd_plain`` against ``_flash_vjp_bwd``
on the same residuals; and both, with the kernel's plain backward
``flash_attention_bwd_ref``, against autograd through the dense
``flash_attention_ref``, a ragged S included.  The forward's ``lse``
against the reference's ``_flash_fwd_impl``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jatt  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.models import attention as tatt  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5   # tests/test_archs_smoke.py:131 has 1e-4, 1e-4
MASKS = [(True, 0), (False, 0), (True, 16)]
B, S, H, KH, D, CHUNK = 2, 64, 8, 2, 32, 16


def _inputs(seed, b=B, s=S, h=H, kh=KH, d=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, do


def _close(got: torch.Tensor, want, what: str, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _port_grads(q, k, v, do, causal, window, chunk=CHUNK, dtype=None):
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    if dtype is not None:
        ts = [t.to(dtype) for t in ts]
    ts = [t.requires_grad_(True) for t in ts]
    out = tatt.gqa_attention(*ts, causal=causal, window=window, chunk=chunk)
    assert out.grad_fn is not None and "_FlashFn" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(do).to(out.dtype))
    return out, [t.grad for t in ts]


@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_fn_grads_match_jax_vjp(causal, window):
    q, k, v, do = _inputs(0)
    fn = lambda q_, k_, v_: jatt.gqa_attention(  # noqa: E731
        q_, k_, v_, causal=causal, window=window, chunk=CHUNK)
    jout, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    out, grads = _port_grads(q, k, v, do, causal, window)
    _close(out, jout, "out")
    for got, want, name in zip(grads, jgrads, "qkv"):
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close(got, want, f"d{name} causal={causal} window={window}")


@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_bwd_plain_matches_reference_vjp_bwd(causal, window):
    """The port of ``_flash_vjp_bwd`` on the reference's own residuals
    (scaled q, repeated kv heads, f32 out and lse)."""
    q, k, v, do = _inputs(1, kh=H)
    qs = q * D ** -0.5
    jout, jlse = jatt._flash_fwd_impl(jnp.asarray(qs), jnp.asarray(k),
                                      jnp.asarray(v), causal, window, CHUNK,
                                      CHUNK)
    jres = (jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v), jout, jlse)
    want = jatt._flash_vjp_bwd(causal, window, CHUNK, CHUNK, jres,
                               jnp.asarray(do))
    t = [torch.from_numpy(x) for x in (qs, k, v)]
    tout, tlse = tatt._flash_fwd_plain(*t, causal, window, CHUNK, CHUNK)
    _close(tout, jout, "forward out")
    _close(tlse, jlse, "forward lse")
    got = tatt._flash_bwd_plain(*t, tout, tlse, torch.from_numpy(do), causal,
                                window, CHUNK)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close(g, w, name)


def _dense_grads(q, k, v, do, causal, window):
    """Autograd through the dense ``flash_attention_ref``, (B, H, S, D)."""
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention_ref(*ts, causal=causal, window=window)
    out.backward(torch.from_numpy(do))
    return out.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_fn_grads_match_autograd_of_dense_ref(causal, window):
    q, k, v, do = _inputs(2)
    t = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3))  # noqa: E731
    _, want = _dense_grads(t(q), t(k), t(v), t(do), causal, window)
    _, got = _port_grads(q, k, v, do, causal, window)
    for g, w, name in zip(got, want, "qkv"):
        _close(g.transpose(1, 2), w, f"d{name}")


@pytest.mark.parametrize("s", [64, 50])
@pytest.mark.parametrize("causal,window", MASKS)
def test_bwd_ref_matches_autograd_of_dense_ref(causal, window, s):
    """The kernel's plain backward, fed the dense forward's output and
    lse, in the kernel's (B, H, S, D) layout; chunks of 16 rows, and a
    ragged S of 50."""
    q, k, v, do = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                   for x in _inputs(3, s=s))
    out, want = _dense_grads(q, k, v, do, causal, window)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out2, lse, out32 = flash_attention_ref(*t, causal=causal, window=window,
                                           return_lse=True)
    assert torch.equal(out, out2) and lse.shape == (B, H, s)
    assert out32 is not None and torch.equal(out32, out)
    got = flash_attention_bwd_ref(*t, out, torch.from_numpy(do), lse,
                                  causal=causal, window=window, chunk=16)
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w, f"d{name} S={s}")


def test_dense_lse_matches_reference_forward_lse():
    q, k, v, _ = _inputs(4, kh=H)
    qs = q * D ** -0.5
    _, jlse = jatt._flash_fwd_impl(jnp.asarray(qs), jnp.asarray(k),
                                   jnp.asarray(v), True, 16, CHUNK, CHUNK)
    t = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
    _, lse, _ = flash_attention_ref(t(q), t(k), t(v), causal=True,
                                    window=16, return_lse=True)
    _close(lse.transpose(1, 2), jlse, "lse")


def test_bf16_grads_come_back_in_bf16_and_match_jax():
    """bf16 inputs: gradients in bf16, within the bf16 tolerance of the
    reference's (2e-2, tests/test_kernels.py)."""
    q, k, v, do = _inputs(5)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    fn = lambda q_, k_, v_: jatt.gqa_attention(  # noqa: E731
        q_, k_, v_, causal=True, window=0, chunk=CHUNK)
    _, vjp = jax.vjp(fn, *jb)
    jgrads = vjp(jnp.asarray(do, jnp.bfloat16))
    ts = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_(True) for x in jb]
    out = tatt.gqa_attention(*ts, causal=True, chunk=CHUNK)
    out.backward(torch.from_numpy(do).to(torch.bfloat16))
    for t, w, name in zip(ts, jgrads, "qkv"):
        assert t.grad.dtype == torch.bfloat16
        _close(t.grad, w.astype(jnp.float32), f"d{name}", rtol=2e-2,
               atol=2e-2)


def test_serving_path_builds_no_graph():
    """Without grad the forward is the plain one: no ``_FlashFn`` node."""
    q, k, v, _ = _inputs(6)
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    out = tatt.gqa_attention(*ts, chunk=CHUNK)
    assert out.grad_fn is None
    with torch.no_grad():
        ts = [t.requires_grad_(True) for t in ts]
        assert tatt.gqa_attention(*ts, chunk=CHUNK).grad_fn is None


def test_bwd_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 2, 8, 32))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, q, q, q, q, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, q, q, return_lse=True)
    assert fa.counter_bwd.name == "flash_attention_bwd"
