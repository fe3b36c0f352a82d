"""Write-combined embedding gradients (``repro_torch.dist.embed_grad``) on
the CPU against the JAX reference (``repro.dist.embed_grad``), on Zipf
token ids (heavy duplicates) and uniform ones, in f32 and bf16:
``hids`` and ``uniq`` bit for bit; ``rows`` within stated tolerances.
The port sums each run in f32 and rounds once to the gradients' dtype;
the reference's ``segment_sum`` adds in the gradients' dtype in its own
order.  So each row is held to the exact (f64) sum of its run within one
rounding (f32: rtol 1e-6 + atol 1e-5; bf16: 2^-8 relative) plus f32
summation (n 2^-24 sum |g|), and to the reference within that plus the
reference's own worst case, n - 1 roundings of the running sum, (n - 1)
u sum |g| for a run of n tokens (u = 2^-24 in f32, 2^-8 in bf16): a hot
id's row of a few hundred bf16 terms moves by whole units there.
``apply_sparse_grad`` and ``dense_embed_grad`` the same way, plus the
table's rounding.  The run flags come from
``core.combine._first_last_rank``, the seam of the ``wc_combine`` kernel
(its plain version here)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.dist import embed_grad as jeg  # noqa: E402
from repro_torch.dist import embed_grad as teg  # noqa: E402
from repro_torch.workloads import zipf  # noqa: E402

VOCAB, DIM = 512, 16
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _ids(kind: str, t: int, seed: int) -> np.ndarray:
    if kind == "zipf":
        gen = torch.Generator().manual_seed(seed)
        cdf = torch.from_numpy(zipf.zipf_cdf_table(VOCAB, 0.99))
        return zipf.sample_zipf_torch(gen, (t,), cdf, VOCAB).numpy()
    return np.random.default_rng(seed).integers(0, VOCAB, t).astype(np.int32)


def _inputs(kind, t, dtype, seed):
    ids = _ids(kind, t, seed)
    g = np.random.default_rng(seed + 1).standard_normal(
        (t, DIM)).astype(np.float32)
    gj = jnp.asarray(g, JNP[dtype])
    gt = torch.from_numpy(np.asarray(gj.astype(jnp.float32))).to(dtype)
    return ids, gj, gt


U = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8}


def _exact(ids, gt):
    """Per id: the f64 sum of its tokens' gradients, the sum of their
    absolute values and the token count."""
    g = gt.double().numpy()
    s = np.zeros((VOCAB, DIM))
    a = np.zeros((VOCAB, DIM))
    np.add.at(s, ids, g)
    np.add.at(a, ids, np.abs(g))
    return s, a, np.bincount(ids, minlength=VOCAB)


def _check_rows(got, want, exact, dtype):
    """``got`` (the port's) and ``want`` (the reference's) rows, one per
    id (VOCAB, DIM), against the exact sums ``exact = (s, a, n)``."""
    s, a, n = exact
    got = got.double().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    ours = U[dtype] * np.abs(s) + 1e-6 + n[:, None] * 2.0 ** -24 * a
    assert np.all(np.abs(got - s) <= ours)
    theirs = ours + np.maximum(n - 1, 0)[:, None] * U[dtype] * a
    assert np.all(np.abs(got - want) <= theirs + U[dtype] * np.abs(want))


def _by_id(h, rows, u):
    out = np.zeros((VOCAB, DIM), np.float32)
    u = np.asarray(u)
    out[np.asarray(h)[u]] = np.asarray(
        jnp.asarray(rows).astype(jnp.float32))[u] if not isinstance(
            rows, torch.Tensor) else rows.float().numpy()[u]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,t", [("zipf", 1000), ("zipf", 4096),
                                    ("uniform", 777), ("uniform", 1)])
def test_combined_embed_grad_matches_reference(kind, t, dtype):
    ids, gj, gt = _inputs(kind, t, dtype, t)
    jh, jr, ju = jeg.combined_embed_grad(jnp.asarray(ids), gj)
    th, tr, tu = teg.combined_embed_grad(torch.from_numpy(ids), gt)
    assert th.dtype == torch.int32 and tu.dtype == torch.bool
    assert tr.dtype == dtype and tr.shape == (t, DIM)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    _check_rows(torch.from_numpy(_by_id(th, tr, tu)), _by_id(jh, jr, ju),
                _exact(ids, gt), dtype)
    assert not bool(tr[~tu].any())          # zeros off the representatives
    if kind == "zipf":
        assert int(tu.sum()) < t // 2       # heavy duplicates


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_apply_sparse_grad_and_dense_match_reference(dtype):
    ids, gj, gt = _inputs("zipf", 2048, dtype, 3)
    table = np.random.default_rng(9).standard_normal(
        (VOCAB, DIM)).astype(np.float32)
    tj = jnp.asarray(table, JNP[dtype])
    tt = torch.from_numpy(np.asarray(tj.astype(jnp.float32))).to(dtype)
    jh, jr, ju = jeg.combined_embed_grad(jnp.asarray(ids), gj)
    want = jeg.apply_sparse_grad(tj, jh, jr, ju, 0.5)
    th, tr, tu = teg.combined_embed_grad(torch.from_numpy(ids), gt)
    got = teg.apply_sparse_grad(tt.clone(), th, tr, tu, 0.5)
    assert got.dtype == dtype
    s, a, n = _exact(ids, gt)
    # table - 0.5 rows: the rows' bounds halved, plus the table's rounding
    # of the update and of the sum (2 u |result|)
    base = tt.double().numpy()
    res = base - 0.5 * s
    slack = 2 * U[dtype] * (np.abs(res) + np.abs(base)) + 1e-6
    ours = 0.5 * (U[dtype] * np.abs(s) + n[:, None] * 2.0 ** -24 * a)
    assert np.all(np.abs(got.double().numpy() - res) <= ours + slack)
    theirs = ours + 0.5 * np.maximum(n - 1, 0)[:, None] * U[dtype] * a
    wnp = np.asarray(want.astype(jnp.float32), np.float64)
    assert np.all(np.abs(got.double().numpy() - wnp) <= theirs + 2 * slack)
    # in place, and only the ids' rows move
    t2 = tt.clone()
    assert teg.apply_sparse_grad(t2, th, tr, tu, 0.5) is t2
    moved = (t2 != tt).any(1).nonzero().squeeze(1).numpy()
    assert set(moved) <= set(ids.tolist())
    dense = teg.dense_embed_grad(torch.from_numpy(ids), gt, VOCAB)
    assert dense.dtype == dtype
    # index_add_ adds in the gradients' dtype in token order: within the
    # reference's worst case of the exact sums, as is the reference's
    d64 = dense.double().numpy()
    bound = np.maximum(n - 1, 0)[:, None] * U[dtype] * a + \
        U[dtype] * np.abs(s) + 1e-6
    assert np.all(np.abs(d64 - s) <= bound)
    jd = np.asarray(jeg.dense_embed_grad(jnp.asarray(ids), gj, VOCAB).astype(
        jnp.float32), np.float64)
    assert np.all(np.abs(jd - s) <= bound)
