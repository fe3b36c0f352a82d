"""Head dim 112, kimi-k2-1t-a32b's, on the CPU against the JAX reference,
and the registry's head dims and group sizes against the kernels' tables.

* ``gqa_attention`` (8 query heads on one kv head, g 8), causal, non-causal
  and a 64-token window, and ``decode_attention`` (kimi's 64 query heads
  on 8 kv heads) at every length 1-40, against the reference's functions;
  the backward (``torch.autograd`` through ``_FlashFn``, whose CPU
  backward is ``_flash_bwd_plain``) against ``jax.vjp`` of the reference's
  ``gqa_attention``.  Tolerances: 2e-5 in f32 and 2e-2 in bf16 for the
  forwards (``tests/test_torch_attention.py``'s); the f32 gradients within
  rtol 1e-4 / atol 1e-5 and the bf16 ones within 2e-2
  (``tests/test_torch_train_attention.py``'s: the gradient sums S products
  in another order).
* kimi-k2-1t-a32b's smoke config with ``head_dim`` 112, the reference's
  weights carried over by ``interop``: the forward's logits and caches, the
  prefill's last logits, 8 decode steps and the final decode state (within
  ``tests/test_torch_models.py``'s tolerance, the reference's expert
  choices replayed as that file does); the loss and every gradient leaf in
  bf16 and f32 (``tests/test_torch_train_families.py``'s ``check_family``;
  in bf16 the auxiliary loss within the bf16 loss's rtol 2e-3 and the
  router's gradient leaf within 3e-2: at D 112 the attention output rounds
  to other bf16 router inputs, the softmaxed router logits the auxiliary
  loss averages moved by 2.5e-4 and the router's gradient by 2.05e-2; in
  f32 every leaf holds 1e-4 and the auxiliary loss 1e-4), and one ``launch.train.train_step`` against the reference's ``main`` step
  (loss within ``LOSS_RTOL``, gradient norm within 2e-2).
* Every registered config with attention layers, published and smoke,
  has a head dim that ``flash_attention`` runs on an instance (its own,
  for a published config), and every one with a decode step one that
  ``paged_attention`` runs, so that no registered arch reaches the card
  with a head dim no kernel takes; head dims past the rule raise;
  ``head_group_plan`` and ``split_plan`` at the registry's group sizes 5,
  8 and 12 (and 4).

The same kernels on the card: ``tests/test_torch_cuda.py``'s D-112 cases
(``cuda``-marked; they skip without a GPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import unbox  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train.optimizer import adamw_init as j_adamw_init  # noqa: E402
from repro.train.optimizer import adamw_update as j_adamw_update  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa  # noqa: E402
from repro_torch.launch.train import train_step  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train.optimizer import adamw_init  # noqa: E402
from test_torch_models import (_MoeReference, _check_logits,  # noqa: E402
                               _check_state, _tokens)
from test_torch_train import LOSS_RTOL  # noqa: E402
from test_torch_train_families import (BOUNDS, _batch,  # noqa: E402
                                       _j_batch, _t_batch, check_family)

D = 112
KIMI = "kimi-k2-1t-a32b"
OVER = {"head_dim": D}       # kimi's smoke config at its published head dim
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
MASKS = [(True, 0), (False, 0), (True, 64)]
GRAD_TOL = {"f32": (1e-4, 1e-5), "bf16": (2e-2, 2e-2)}

j_decode = jax.jit(jatt.decode_attention)


def _pair(arr: np.ndarray, dt: str):
    """The same values as a JAX array and a CPU tensor of dtype ``dt``
    (bf16 rounded once, by JAX)."""
    jdt, tdt, _ = DTYPES[dt]
    j = jnp.asarray(arr, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _close(got: torch.Tensor, want, rtol: float, atol: float, what=""):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _qkv(seed: int, b: int, s: int, h: int, kh: int):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, s, h, D), (b, s, kh, D), (b, s, kh, D), (b, s, h, D)))


# ---------------------------------------------------------------------------
# attention at D 112
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("causal,window", MASKS)
def test_gqa_attention_d112_matches_reference(causal, window, dt):
    """8 query heads on one kv head, S 256 in chunks of 128."""
    q, k, v, _ = _qkv(1, 2, 256, 8, 1)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dt) for x in (q, k, v))
    kw = dict(causal=causal, window=window, chunk=128)
    got = tatt.gqa_attention(qt, kt, vt, **kw)
    want = jatt.gqa_attention(qj, kj, vj, **kw)
    tol = DTYPES[dt][2]
    assert got.dtype == DTYPES[dt][1] and tuple(got.shape) == q.shape
    _close(got, want.astype(jnp.float32), tol, tol)
    # the kernel's plain version is the same function
    fwant = fa.flash_attention_ref(qt.transpose(1, 2), kt.transpose(1, 2),
                                   vt.transpose(1, 2), causal=causal,
                                   window=window).transpose(1, 2)
    _close(got, fwant.to(torch.float32).numpy(), tol, tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_decode_attention_d112_matches_reference(dt):
    """kimi's 64 query heads on 8 kv heads over a 40-row cache, every
    length 1-40, and the identity block table through the paged kernel's
    plain version."""
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng.standard_normal((1, 1, 64, D)), dt)
    kj, kt = _pair(rng.standard_normal((1, 40, 8, D)), dt)
    vj, vt = _pair(rng.standard_normal((1, 40, 8, D)), dt)
    tol = DTYPES[dt][2]
    ident = torch.zeros((1, 1), dtype=torch.int32)
    for n in range(1, 41):
        got = tatt.decode_attention(qt, kt, vt, n)
        want = np.asarray(j_decode(qj, kj, vj, jnp.int32(n)).astype(
            jnp.float32))
        _close(got, want, tol, tol, f"length {n}")
        paged = pa.paged_attention_ref(qt[:, 0], kt, vt, ident,
                                       torch.tensor([n], dtype=torch.int32))
        _close(paged, want[:, 0], tol, tol, f"paged length {n}")


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_backward_d112_matches_jax_vjp(causal, window, dt):
    """dq, dk and dv through ``_FlashFn`` on the CPU against ``jax.vjp``
    of the reference's ``gqa_attention``: 8 query heads on 2 kv heads, S
    128 in chunks of 64."""
    q, k, v, do = _qkv(3, 2, 128, 8, 2)
    jargs = [_pair(x, dt) for x in (q, k, v, do)]
    kw = dict(causal=causal, window=window, chunk=64)
    leaves = [t.requires_grad_(True) for _, t in jargs[:3]]
    out = tatt.gqa_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, jargs[3][1])
    j32 = [j.astype(jnp.float32) for j, _ in jargs]
    want_out, vjp = jax.vjp(lambda q_, k_, v_: jatt.gqa_attention(
        q_, k_, v_, **kw), *j32[:3])
    tol = DTYPES[dt][2]
    _close(out, want_out, tol, tol, "out")
    rtol, atol = GRAD_TOL[dt]
    for g, w, name in zip(got, vjp(j32[3]), ("dq", "dk", "dv")):
        assert g.dtype == DTYPES[dt][1], name
        _close(g, w, rtol, atol, name)


# ---------------------------------------------------------------------------
# kimi-k2-1t-a32b's smoke config at head dim 112
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kimi():
    """(JAX model, JAX params, port model, port params) of kimi's smoke
    config with ``head_dim`` 112."""
    jm = JModel(dataclasses.replace(j_get_config(KIMI, smoke=True), **OVER))
    jp = unbox(jm.init(jax.random.key(0)))
    tm = Model(dataclasses.replace(get_config(KIMI, smoke=True), **OVER),
               device="cpu")
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tm.cfg.hd == jm.cfg.hd == D
    return jm, jp, tm, tp


def test_kimi_d112_forward_and_prefill_match_reference(kimi):
    """The forward's logits and caches (B 2 x S 128, two attention chunks
    of the smoke config's 64) and the prefill's last logits, the
    reference's expert choices replayed."""
    jm, jp, tm, tp = kimi
    cfg = tm.cfg
    toks = _tokens(cfg, 2, 128)
    jl, jaux, jc, choices = _MoeReference(jm.cfg, jp).forward(toks)
    with tmoe.pinned_routing(replay=choices) as flips:
        tl, taux, tc = ttfm.forward(cfg, tp, torch.from_numpy(toks),
                                    return_cache=True)
    assert flips[1] > 0 and flips[0] <= 0.1 * flips[1], flips
    _check_logits(tl, jl, "kimi D 112 forward", cfg)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)
    for got, want, name in zip(tc, jc, ("k", "v")):
        assert tuple(got.shape) == want.shape and got.shape[-1] == D
        _close(got, want, 2e-2, 6.25e-2, f"cache {name}")
    with tmoe.pinned_routing(replay=choices):
        pl, caches = tm.prefill(tp, torch.from_numpy(toks))
    assert tuple(pl.shape) == (2, 1, cfg.vocab)
    assert tuple(caches[0].shape) == (cfg.n_layers, 2, 128, cfg.n_kv, D)
    _check_logits(pl, jl[:, -1:], "kimi D 112 prefill", cfg)


def test_kimi_d112_decode_matches_reference(kimi):
    """8 decode steps from a zero state (B 2), each step's logits and the
    final decode state against the reference's, the reference's expert
    choices replayed a step at a time."""
    jm, jp, tm, tp = kimi
    cfg = tm.cfg
    toks = _tokens(cfg, 2, 8, seed=3)
    ref = _MoeReference(jm.cfg, jp)
    jst, tst = jm.init_decode_state(2, 8), tm.init_decode_state(2, 8)
    got, want = [], []
    for t in range(8):
        tok = toks[:, t:t + 1]
        jlg, jst, choices = ref.decode_step(jst, tok, t)
        with tmoe.pinned_routing(replay=choices):
            tlg, tst = tm.decode_step(tp, tst, torch.from_numpy(tok), t)
        _check_logits(tlg, jlg, f"kimi D 112 decode step {t}", cfg,
                      argmax=False)
        got.append(tlg)
        want.append(np.asarray(jlg, np.float32))
    _check_logits(torch.cat(got, 1), np.concatenate(want, 1),
                  "kimi D 112 decode steps", cfg)
    _check_state(tst, jst, cfg, "kimi D 112 decode state")
    assert tst["k"].shape[-1] == D


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_kimi_d112_loss_and_grads_match_reference(dtype, monkeypatch):
    bf16 = dtype == "bf16"
    check_family(KIMI, dtype, monkeypatch, over=OVER,
                 aux_rtol=BOUNDS["bf16"][0] if bf16 else 1e-4,
                 leaf_bounds={"blocks/router": 3e-2} if bf16 else None)


def test_kimi_d112_train_step_matches_reference_main_step(monkeypatch):
    """One ``train_step`` (AdamW at lr 3e-4) against the reference's
    ``main`` step (``value_and_grad`` of its ``loss_fn``, then
    ``adamw_update``) on the same weights and batch, the reference's expert
    choices replayed, ``remat="none"`` on both sides: the loss, and the
    gradient norm within 2e-2."""
    jcfg, tcfg = (dataclasses.replace(c, remat="none", **OVER) for c in (
        j_get_config(KIMI, smoke=True), get_config(KIMI, smoke=True)))
    jm = JModel(jcfg)
    jp = unbox(jm.init(jax.random.key(0)))
    choices = []
    route = jmoe.route_topk

    def recording(logits, top_k):
        w, ix = route(logits, top_k)
        jax.debug.callback(lambda a: choices.append(np.array(a)), ix)
        return w, ix
    monkeypatch.setattr(jmoe, "route_topk", recording)
    jax.clear_caches()

    @jax.jit
    def step_fn(params, opt, batch):
        (loss, _), grads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
            params, batch)
        params, opt, gnorm = j_adamw_update(params, grads, opt, lr=3e-4)
        return params, opt, loss, gnorm

    batch = _batch(tcfg)
    _, _, jl, jg = step_fn(jp, j_adamw_init(jp), _j_batch(batch, False))
    jax.effects_barrier()
    assert len(choices) == tcfg.n_layers
    tm = Model(tcfg, device="cpu")
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    with tmoe.pinned_routing(replay=choices) as flips:
        _, _, loss, gnorm, _ = train_step(tm, params, adamw_init(params),
                                          _t_batch(batch, False), (), 3e-4,
                                          False)
    assert flips[0] <= 0.1 * flips[1], flips
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(gnorm), float(jg), rtol=2e-2)


# ---------------------------------------------------------------------------
# the registry against the kernels' head dims and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["published", "smoke"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_registered_head_dims_have_kernels(arch, smoke):
    """Every registered config with attention layers (all but the ssm),
    published and smoke, has its head dim on an instance of
    ``flash_attention`` in bf16 and f32, forward and backward on the tensor
    cores in bf16, and every one with a decode step on an instance of
    ``paged_attention``; a published head dim is an instance of its own,
    unpadded, in one pass (no published path runs zero columns or a
    padded copy), recurrentgemma-9b's smoke D 16 runs on the 32-column
    instances.  Head dims no config has get plans too: D 264 two column
    passes of the 256 instances, D 20 in bf16 (a row of 40 bytes, not
    whole 16-byte chunks) a padded flash copy 24 wide on 32, and paged's
    own loads on 32."""
    cfg = get_config(arch, smoke=smoke)
    blocks = Model(cfg, device="cpu").init_abstract()["blocks"]
    if cfg.family == "ssm":     # no attention layer
        assert "wq" not in blocks
        return
    for dtype in (torch.bfloat16, torch.float32):
        w = fa.instance_of(cfg.hd, dtype)
        assert w in fa.INSTANCES and w >= cfg.hd, (arch, cfg.hd, w)
        assert w == min(x for x in fa.INSTANCES if x >= cfg.hd)
        assert w in fa.FWD_TENSOR_CORE_DIMS, (arch, cfg.hd)
        assert w in fa.BWD_TENSOR_CORE_DIMS, (arch, cfg.hd)
        assert fa.plan_of(cfg.hd, dtype) == (cfg.hd, w, 1, False)
        if cfg.has_decode:
            wp = pa.instance_of(cfg.hd, dtype)
            assert wp in pa.INSTANCES and wp >= cfg.hd, (arch, cfg.hd, wp)
            assert pa.plan_of(cfg.hd, dtype) == (cfg.hd, wp, 1, False)
        if not smoke:
            assert w == cfg.hd, (arch, cfg.hd, w)
            if cfg.has_decode:
                assert wp == cfg.hd, (arch, cfg.hd, wp)
    if arch == "recurrentgemma-9b" and smoke:
        assert cfg.hd == 16 and fa.instance_of(16, torch.bfloat16) == 32
        assert pa.instance_of(16, torch.bfloat16) == 32
    for ops in (fa, pa):
        assert ops.plan_of(264, torch.bfloat16) == (264, 256, 2, False)
        assert ops.instance_of(20, torch.float32) == 32
    assert fa.plan_of(20, torch.bfloat16) == (20, 32, 1, True)
    assert pa.plan_of(20, torch.bfloat16) == (20, 32, 1, False)
    assert cfg.n_heads % cfg.n_kv == 0


@pytest.mark.parametrize("arch,b,span,groups,split", [
    ("qwen2.5-32b", 1, 40, 5, (512, 1)),         # g 5: 8 blocks -> 40
    ("minitron-8b", 1, 40, 4, (512, 1)),         # g 4: -> 32
    ("mistral-large-123b", 1, 40, 12, (512, 1)),  # g 12: -> 96
    (KIMI, 1, 40, 8, (512, 1)),                  # g 8: -> 64
    (KIMI, 1, 4096, 4, (512, 8)),                # 64 blocks -> 256
    ("qwen2.5-32b", 1, 4096, 5, (512, 8)),       # 64 -> 320 (5 divides g)
    ("mistral-large-123b", 1, 4096, 3, (512, 8)),  # 64 -> 192
    ("mistral-large-123b", 8, 32768, 1, (512, 64)),  # decode_32k: full
    (KIMI, 8, 32768, 1, (512, 64))])
def test_group_size_plans(arch, b, span, groups, split):
    """``head_group_plan`` and ``split_plan`` at the registry's group
    sizes, on an H100 SXM's 132 SMs: the fewest groups, a divisor of g,
    that fill the grid, or g; the split from the span alone."""
    cfg = get_config(arch)
    g = cfg.n_heads // cfg.n_kv
    assert pa.split_plan(span) == split
    got = pa.head_group_plan(b, cfg.n_kv, g, span, 132)
    assert got == groups and g % got == 0
    blocks = b * cfg.n_kv * split[1]
    assert blocks * got >= 132 or got == g

