"""The port's recurrent layers on the CPU against the JAX reference: Mamba-2
SSD (``repro_torch.models.ssm`` vs ``repro.models.ssm``), RG-LRU and the
depthwise causal conv (``repro_torch.models.rglru`` vs
``repro.models.rglru``), the log-depth ``associative_scan`` they run on,
and the hybrid model's windowed decode past the window, where its
attention cache is a ring.  Inputs come from numpy seeds.

Tolerances.  f32: 1e-5 relative and absolute for the scans, whose
products and sums both sides take in the same order (the port's
``associative_scan`` is the reference's algorithm, bit for bit on the
same combine), and 1e-4 for SSD, whose einsums sum in another order.
bf16: the outputs are one rounding of an f32 computation on both sides,
so 2^-7 relative (one ulp) plus 1e-6.  The hybrid model: the model tests'
hybrid tolerance, rtol 1e-1 / atol 1.5e-1 (``tests/test_torch_models.py``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import unbox  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.common import associative_scan  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": (1e-5, 1e-5), "bf16": (2.0 ** -7, 1e-6)}
HYBRID_RTOL, HYBRID_ATOL = 1e-1, 1.5e-1


def _pair(a, dt):
    """The same values as a JAX array and a torch tensor of dtype ``dt``."""
    _, jd, td = DTYPES[dt]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)
                                                ).to(td)


def _close(got, want, dt, rtol=None, atol=None, what=""):
    r, a = TOL[dt]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               rtol=r if rtol is None else rtol,
                               atol=a if atol is None else atol, err_msg=what)


def _lin(left, right):
    return right[0] + left[0] * right[1], left[1] * right[1]


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 33, 100, 4096])
def test_associative_scan_bit_for_bit(n):
    rng = np.random.default_rng(n)
    # decays whose running products stay above 2^-8 (XLA flushes f32
    # denormals to zero, PyTorch keeps them)
    a = (rng.uniform(0.5, 1.0, (2, n, 5)) ** (8 / n)).astype(np.float32)
    b = rng.standard_normal((2, n, 5)).astype(np.float32)
    jh, ja = jax.lax.associative_scan(_lin, (jnp.asarray(b), jnp.asarray(a)),
                                      axis=1)
    th, ta = associative_scan(_lin, (torch.from_numpy(b), torch.from_numpy(a)),
                              dim=1)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def _ssd_inputs(b, s, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    D = rng.uniform(0.5, 1.5, h).astype(np.float32)
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (48, 48)])
def test_ssd_chunked_matches_reference_and_naive(dt, s, chunk):
    """``ssd_chunked``'s output and final state against the reference's,
    and against the port's sequential ``ssd_naive``; x, B and C in ``dt``,
    dt, A and D in f32 (as the model feeds them)."""
    x, dtv, A, Bm, Cm, D = _ssd_inputs(2, s, 4, 8, 2, 16, s + chunk)
    jx, tx = _pair(x, dt)
    jB, tB = _pair(Bm, dt)
    jC, tC = _pair(Cm, dt)
    f32 = (jnp.asarray(dtv), jnp.asarray(A), jnp.asarray(D))
    t32 = tuple(torch.from_numpy(v) for v in (dtv, A, D))
    jy, jst = jssm.ssd_chunked(jx, f32[0], f32[1], jB, jC, f32[2], chunk=chunk)
    ty, tst = tssm.ssd_chunked(tx, t32[0], t32[1], tB, tC, t32[2],
                               chunk=chunk)
    assert ty.dtype == tx.dtype and tst.dtype == torch.float32
    _close(ty, jy, dt, rtol=None if dt == "bf16" else 1e-4,
           atol=None if dt == "bf16" else 1e-4, what="y")
    _close(tst, jst, "f32", rtol=1e-4, atol=1e-4, what="state")
    ny, nst = tssm.ssd_naive(tx, t32[0], t32[1], tB, tC, t32[2])
    torch.testing.assert_close(ny.float(), ty.float(), rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(nst, tst, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_ssd_decode_step_matches_reference(dt):
    x, dtv, A, Bm, Cm, D = _ssd_inputs(3, 1, 4, 8, 2, 16, 5)
    st = np.random.default_rng(6).standard_normal((3, 4, 8, 16)
                                                  ).astype(np.float32)
    jx, tx = _pair(x[:, 0], dt)
    jB, tB = _pair(Bm[:, 0], dt)
    jC, tC = _pair(Cm[:, 0], dt)
    jy, jst = jssm.ssd_decode_step(jnp.asarray(st), jx, jnp.asarray(dtv[:, 0]),
                                   jnp.asarray(A), jB, jC, jnp.asarray(D))
    ty, tst = tssm.ssd_decode_step(torch.from_numpy(st), tx,
                                   torch.from_numpy(dtv[:, 0]),
                                   torch.from_numpy(A), tB, tC,
                                   torch.from_numpy(D))
    _close(ty, jy, dt, what="y")
    _close(tst, jst, "f32", what="state")


def _rglru_inputs(b, s, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    wi = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    wr = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    lam = np.linspace(0.9, 4.0, d).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return x, wi, wr, lam, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_rglru_scan_matches_reference(dt, with_h0):
    x, wi, wr, lam, h0 = _rglru_inputs(2, 100, 16, 3)
    jx, tx = _pair(x, dt)
    jwi, twi = _pair(wi, dt)
    jwr, twr = _pair(wr, dt)
    jy, jh = jrg.rglru_scan(jx, jwi, jwr, jnp.asarray(lam),
                            jnp.asarray(h0) if with_h0 else None)
    ty, th = trg.rglru_scan(tx, twi, twr, torch.from_numpy(lam),
                            torch.from_numpy(h0) if with_h0 else None)
    assert ty.dtype == tx.dtype and th.dtype == torch.float32
    _close(ty, jy, dt, what="y")
    _close(th, jh, "f32", rtol=1e-5, atol=1e-5, what="h")


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rglru_step_matches_reference_and_scan(dt):
    """One step against the reference's, and a run of steps against the
    port's own scan (the decode == prefill contract)."""
    x, wi, wr, lam, h0 = _rglru_inputs(2, 12, 16, 4)
    jx, tx = _pair(x, dt)
    jwi, twi = _pair(wi, dt)
    jwr, twr = _pair(wr, dt)
    jy, jh = jrg.rglru_step(jnp.asarray(h0), jx[:, 0], jwi, jwr,
                            jnp.asarray(lam))
    ty, th = trg.rglru_step(torch.from_numpy(h0), tx[:, 0], twi, twr,
                            torch.from_numpy(lam))
    _close(ty, jy, dt, what="y")
    _close(th, jh, "f32", what="h")
    h = torch.zeros((2, 16))
    steps = []
    for t in range(12):
        y, h = trg.rglru_step(h, tx[:, t], twi, twr, torch.from_numpy(lam))
        steps.append(y)
    sy, sh = trg.rglru_scan(tx, twi, twr, torch.from_numpy(lam))
    _close(torch.stack(steps, 1), sy.float().numpy(), dt)
    _close(h, sh.numpy(), "f32")


@pytest.mark.parametrize("dt", list(DTYPES))
def test_causal_conv1d_and_step_match_reference(dt):
    """The conv over a sequence, bit for bit in f32 (taps summed in the
    same order) and within one rounding in bf16; then ``conv1d_step`` over
    the same sequence equals the prefill conv exactly (one rounding of the
    same f32 sums) and the reference's steps."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 20, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    jx, tx = _pair(x, dt)
    jw, tw = _pair(w, dt)
    jy = jrg.causal_conv1d(jx, jw)
    ty = trg.causal_conv1d(tx, tw)
    assert ty.dtype == tx.dtype
    _close(ty, jy, dt, rtol=0 if dt == "f32" else None,
           atol=0 if dt == "f32" else None)
    jtail = jnp.zeros((2, 3, 24), jx.dtype)
    ttail = torch.zeros((2, 3, 24), dtype=tx.dtype)
    for t in range(20):
        jyt, jtail = jrg.conv1d_step(jtail, jx[:, t], jw)
        tyt, ttail = trg.conv1d_step(ttail, tx[:, t], tw)
        assert torch.equal(tyt, ty[:, t])
        _close(tyt, jyt, dt)
    _close(ttail, jtail, dt, rtol=0, atol=0)


def _hybrid_ring_against_reference(n_layers):
    """``recurrentgemma-9b``'s smoke config (window 16) cut or grown to
    ``n_layers`` decodes 40 tokens, so its attention cache (a ring of 16
    rows: slot pos % 16, length min(pos + 1, 16)) wraps twice: every
    step's logits against the reference's decode and against the
    reference's forward over the same tokens, and the final decode state
    (every triple's ring and recurrent state, and the tail's) against the
    reference's."""
    import dataclasses
    jcfg = dataclasses.replace(j_get_config("recurrentgemma-9b", smoke=True),
                               n_layers=n_layers)
    jm = JModel(jcfg)
    jp = unbox(jm.init(jax.random.key(1)))
    cfg = dataclasses.replace(get_config("recurrentgemma-9b", smoke=True),
                              n_layers=n_layers)
    tm = Model(cfg, device="cpu")
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert cfg.window == 16
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 64)
                                             ).astype(np.int32)
    full, _, _ = jtfm.forward(jm.cfg, jp, jnp.asarray(toks))
    jst = jm.init_decode_state(2, 40)
    tst = tm.init_decode_state(2, 40)
    assert tuple(tst["k"].shape[:3]) == (n_layers // 3, 2, 16)
    jdec = jax.jit(jm.decode_step)
    got, want = [], []
    for t in range(40):
        tok = toks[:, t:t + 1]
        jlg, jst = jdec(jp, jst, jnp.asarray(tok), jnp.int32(t))
        tlg, tst = tm.decode_step(tp, tst, torch.from_numpy(tok), t)
        got.append(tlg[:, 0].float().numpy())
        want.append(np.asarray(jlg[:, 0], np.float32))
    got, want = np.stack(got, 1), np.stack(want, 1)
    for ref, what in ((want, "reference decode"),
                      (np.asarray(full[:, :40], np.float32),
                       "reference forward")):
        np.testing.assert_allclose(got, ref, rtol=HYBRID_RTOL,
                                   atol=HYBRID_ATOL, err_msg=what)
        assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.9, what
    back = interop.decode_state_to_numpy(tst)
    assert sorted(back) == sorted(jst)
    for name in jst:
        np.testing.assert_allclose(back[name], np.asarray(jst[name],
                                                          np.float32),
                                   rtol=HYBRID_RTOL, atol=HYBRID_ATOL,
                                   err_msg=name)
    # the ring holds positions 24-39: slot pos % 16 of the last step's keys
    jk = np.asarray(jst["k"], np.float32)
    assert np.array_equal(back["k"] != 0, jk != 0)


def test_hybrid_decode_wraps_the_ring_against_reference():
    """The smoke config's 5 layers: one (rec, rec, attn) triple and a tail
    of two recurrent layers."""
    _hybrid_ring_against_reference(5)


def test_hybrid_two_triples_decode_against_reference():
    """8 layers: two triples, so the per-triple indexing of the decode
    state (the ring caches and recurrent states stacked over triples) is
    held, and the tail of two recurrent layers."""
    _hybrid_ring_against_reference(8)


def test_decode_state_round_trip_keeps_bits():
    """Any family's decode state through ``decode_state_from_numpy`` and
    back: bf16 caches and conv tails as exact f32, f32 states as they are."""
    for arch in ("recurrentgemma-9b", "mamba2-1.3b", "deepseek-moe-16b"):
        jm = JModel(j_get_config(arch, smoke=True))
        rng = np.random.default_rng(3)
        st = {k: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
              for k, v in jm.init_decode_state(2, 8).items()}
        tst = interop.decode_state_from_numpy(
            jax.tree.map(np.asarray, st), "cpu")
        for k, v in st.items():
            assert str(tst[k].dtype).removeprefix("torch.") == str(v.dtype)
        back = interop.decode_state_to_numpy(tst)
        for k, v in st.items():
            assert np.array_equal(back[k].astype(v.dtype).view(np.uint8),
                                  np.asarray(v).view(np.uint8)), (arch, k)


def _mamba_decode_vs_prefill(n_layers, n_tok):
    """``mamba2-1.3b`` at full width cut to ``n_layers``, the reference's
    weights: (reference, port) fractions of the decode logits of ``n_tok``
    tokens beyond the model tolerance of their own forward's."""
    import dataclasses
    jcfg = dataclasses.replace(j_get_config("mamba2-1.3b"), n_layers=n_layers)
    jm = JModel(jcfg)
    jp = unbox(jm.init(jax.random.key(0)))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (1, n_tok)
                                             ).astype(np.int32)
    full, _, _ = jtfm.forward(jcfg, jp, jnp.asarray(toks))
    st = jm.init_decode_state(1, n_tok)
    dec = jax.jit(jm.decode_step)
    outs = []
    for t in range(n_tok):
        lg, st = dec(jp, st, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        outs.append(np.asarray(lg[:, 0], np.float32))
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=n_layers)
    tm = Model(cfg, device="cpu")
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    del jp
    tfull, _, _ = ttfm.forward(cfg, tp, torch.from_numpy(toks))
    tst = tm.init_decode_state(1, n_tok)
    touts = []
    for t in range(n_tok):
        lg, tst = tm.decode_step(tp, tst, torch.from_numpy(toks[:, t:t + 1]),
                                 t)
        touts.append(lg[:, 0].float().numpy())
    fracs = []
    for dec_l, fwd in ((np.stack(outs, 1), np.asarray(full, np.float32)),
                       (np.stack(touts, 1), tfull.float().numpy())):
        bad = np.abs(dec_l - fwd) > HYBRID_ATOL + HYBRID_RTOL * np.abs(fwd)
        fracs.append(float(bad.mean()))
    return fracs


def test_mamba2_decode_drifts_from_prefill_with_depth_in_the_reference():
    """A property of the reference that ``chip_smoke.py`` works around:
    at ``mamba2-1.3b``'s full width with random bf16 weights, the chunked
    prefill and the recurrent decode round differently, and the difference
    grows with depth.  Over 24 tokens, at 2 layers the reference's decode
    logits lie within the decode-vs-prefill tolerance of
    ``tests/test_archs_smoke.py`` (rtol 1e-1, atol 1.5e-1) of its own
    forward's, and at 16 layers they do not; the port does the same.  So
    ``chip_smoke.py`` holds decode to prefill at a cut depth and prints the
    full-depth figures (the full model has 48 layers)."""
    ref2, port2 = _mamba_decode_vs_prefill(2, 24)
    assert ref2 == port2 == 0.0
    ref16, port16 = _mamba_decode_vs_prefill(16, 24)
    assert ref16 > 0 and port16 > 0
