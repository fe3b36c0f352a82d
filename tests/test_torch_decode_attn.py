"""Split-sequence decode attention (``repro_torch.dist.decode_attn``) on
the CPU against the JAX reference's ``decode_attention_spmd`` on the 8 host
devices (a ``(1, n)`` mesh whose ``model`` axis splits the cache): n 2, 4
and 8, lengths 0, 1, Smax/n, Smax/n + 1 and Smax, and a (B,) length
tensor (held row by row: the reference takes one length for the batch);
1e-5 in f32 and 2e-2 in bf16 (``tests/test_kernels.py``'s attention
tolerances), and in bf16 also two ulps (both merge in f32 and round
once).  The port's local mesh runs every part in one process through
one call of the paged kernel's plain version (``paged_attention_ref`` with
its log-sum-exp) and merges the parts by their weights (the run on gloo
ranks is tests/test_torch_decode_attn_ranks.py).  Also: the plain version's log-sum-exp against
the reference's scores, the reference's fallbacks (n = 1, an Smax that n
does not divide), and the uniform average at length 0."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.dist.decode_attn import (  # noqa: E402
    decode_attention_spmd as j_spmd)
from repro.models.attention import decode_attention as j_decode  # noqa: E402
from repro_torch.dist.decode_attn import decode_attention_spmd  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.attention import decode_attention  # noqa: E402

B, H, KH, D, SMAX = 2, 8, 2, 32, 64
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

j_spmd = jax.jit(j_spmd, static_argnums=0)
j_decode = jax.jit(j_decode)


def _inputs(dtype, seed, smax=SMAX, b=B):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((b, 1, H, D), (b, smax, KH, D), (b, smax, KH, D))]
    j = [jnp.asarray(a, JNP[dtype]) for a in arrs]
    t = [torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(dtype)
         for x in j]
    return j, t


def _lengths(n: int, smax: int = SMAX) -> list[int]:
    part = smax // n
    return sorted({0, 1, part, part + 1, smax})


def _close(got, want, dtype):
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])
    if dtype == torch.bfloat16:
        # both sum the parts in f32 and round once: two bf16 ulps at most
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=2.0 ** -6, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_split_decode_matches_reference_spmd(n, dtype):
    (qj, kj, vj), (qt, kt, vt) = _inputs(dtype, n)
    jmesh = jax.make_mesh((1, n), ("data", "model"))
    mesh = tmesh.make_local_mesh(1, "cpu", model=n)
    for length in _lengths(n):
        got = decode_attention_spmd(mesh, qt, kt, vt, length)
        assert got.dtype == dtype and got.shape == (B, 1, H, D)
        _close(got, j_spmd(jmesh, qj, kj, vj, length), dtype)
        # and the unsplit reference
        _close(got, j_decode(qj, kj, vj, length), dtype)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_split_decode_per_row_lengths(n):
    """A (B,) length tensor, each row against the reference at its own
    length; rows at 0 and at a part's boundary."""
    b = 4
    (qj, kj, vj), (qt, kt, vt) = _inputs(torch.float32, 10 + n, b=b)
    part = SMAX // n
    lens = [0, part, part + 1, SMAX - 3]
    got = decode_attention_spmd(tmesh.make_local_mesh(1, "cpu", model=n),
                                qt, kt, vt,
                                torch.tensor(lens, dtype=torch.int32))
    jmesh = jax.make_mesh((1, n), ("data", "model"))
    for i, ln in enumerate(lens):
        want = j_spmd(jmesh, qj[i:i + 1], kj[i:i + 1], vj[i:i + 1], ln)
        _close(got[i:i + 1], want, torch.float32)


def test_length_zero_is_the_uniform_average():
    (_, _, _), (qt, kt, vt) = _inputs(torch.float32, 3)
    got = decode_attention_spmd(tmesh.make_local_mesh(1, "cpu", model=4),
                                qt, kt, vt, 0)
    want = vt.float().mean(1).repeat_interleave(H // KH, dim=1)
    torch.testing.assert_close(got[:, 0], want, rtol=1e-5, atol=1e-6)


def test_fallbacks_are_plain_decode_attention():
    """n = 1, or an Smax that n does not divide: plain ``decode_attention``
    (the reference's rule), bit for bit."""
    (_, _, _), (qt, kt, vt) = _inputs(torch.float32, 4, smax=60)
    for mesh in (tmesh.make_local_mesh(1, "cpu"),
                 tmesh.make_local_mesh(1, "cpu", model=8)):
        assert torch.equal(decode_attention_spmd(mesh, qt, kt, vt, 37),
                           decode_attention(qt, kt, vt, 37))
    with pytest.raises(KeyError):
        decode_attention_spmd(tmesh.make_local_mesh(1, "cpu"), qt, kt, vt,
                              5, seq_axis="pod")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_plain_lse(dtype):
    """``paged_attention_ref(return_lse=True)``: the log-sum-exp of each
    head's scaled, masked scores (the reference's scores, computed here in
    f32) and the output in f32, which rounds to the output without it; a
    length 0 gives output 0 and lse -inf."""
    (qj, kj, _), (qt, kt, vt) = _inputs(dtype, 5)
    bt = torch.arange(B, dtype=torch.int32).view(B, 1)
    for length in (0, 1, 40, SMAX):
        ln = torch.full((B,), length, dtype=torch.int32)
        out, lse = pa.paged_attention_ref(qt[:, 0], kt, vt, bt, ln,
                                          return_lse=True)
        assert lse.dtype == torch.float32 and lse.shape == (B, H)
        assert out.dtype == torch.float32 and out.shape == (B, H, D)
        if length == 0:
            assert not bool(out.any()) and bool((lse == -torch.inf).all())
            continue
        assert torch.equal(out.to(dtype), pa.paged_attention_ref(
            qt[:, 0], kt, vt, bt, ln))
        q32 = np.asarray(qj.astype(jnp.float32)).reshape(B, KH, H // KH, D)
        sc = np.einsum("bkgd,bskd->bkgs", q32 * D ** -0.5,
                       np.asarray(kj.astype(jnp.float32)))
        sc = np.where(np.arange(SMAX) < length, sc, -1e30)
        want = jax.scipy.special.logsumexp(jnp.asarray(sc), -1)
        np.testing.assert_allclose(lse.numpy(),
                                   np.asarray(want).reshape(B, H),
                                   rtol=1e-5, atol=1e-5)
