"""The port's models on the CPU against the JAX reference, at the smoke
config of every family: dense ``qwen3-0.6b`` (qk_norm, tied embedding) and
``qwen2.5-32b`` (qkv_bias, separate head), moe ``deepseek-moe-16b`` and
``kimi-k2-1t-a32b``, ssm ``mamba2-1.3b``, hybrid ``recurrentgemma-9b``,
encoder ``hubert-xlarge`` (audio stub) and vlm ``phi-3-vision-4.2b``
(vision stub), with the reference's own initial weights carried into the
port by ``interop.params_from_numpy`` and the frontend features drawn by
numpy.

Tolerance: logits and caches within rtol 2e-2, atol 6.25e-2 of the
reference's, and argmax agreement on at least 90 % of the positions.  Both
run bf16 weights and activations; XLA and PyTorch round their bf16 matmuls
and their f32 sin/pow in RoPE at different places, so about one element in
a thousand lands one or two bf16 ulps away (an ulp is 0.03125 for |x| in
[4, 8)); atol is two such ulps.  Tighter than ``tests/test_archs_smoke.py``'s
decode-vs-prefill rtol 1e-1 / atol 1.5e-1.  Two families differ:

* hybrid: rtol 1e-1 / atol 1.5e-1 (``test_archs_smoke.py``'s).  Its smoke
  config has five layers, three of them recurrent, against the others' two;
  each rounds its bf16 activations at other places than XLA's fusions, and
  the difference grows by about one bf16 ulp a layer.
* moe: top-k routing over bf16 router logits flips at near-ties under any
  change of rounding, a flipped token's output moves by far more than the
  tolerance, and through attention the flip reaches the later positions.
  The reference is not consistent with itself there either: its forward
  under one ``lax.scan`` and the same layers jitted one at a time route a
  few tokens differently.  So the moe checks evaluate the reference
  layer by layer, record each MoE layer's expert choices, and have the
  port take the same choices (``moe.pinned_routing``; its gate weights
  still come from its own logits); ``tests/test_torch_moe.py`` holds the
  routing itself bit for bit on shared logits.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models.common import rms_norm as j_rms_norm  # noqa: E402
from repro.models.common import rope as j_rope  # noqa: E402
from repro.models.common import unbox  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCHS = ["qwen3-0.6b", "qwen2.5-32b", "deepseek-moe-16b", "kimi-k2-1t-a32b",
         "mamba2-1.3b", "recurrentgemma-9b", "hubert-xlarge",
         "phi-3-vision-4.2b"]
DECODE_ARCHS = [a for a in ARCHS if get_config(a, smoke=True).has_decode]
RTOL, ATOL = 2e-2, 6.25e-2
FAMILY_TOL = {"hybrid": (1e-1, 1.5e-1)}     # see the module docstring
B, S = 2, 128        # two attention chunks of the smoke config's 64


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX model, JAX params, port model, port params)."""
    arch = request.param
    jm = JModel(j_get_config(arch, smoke=True))
    jp = unbox(jm.init(jax.random.key(0)))
    if jm.cfg.qkv_bias:   # the reference inits biases to 0: make them count
        rng = np.random.default_rng(1)
        jp["blocks"] = dict(jp["blocks"], **{
            n: jnp.asarray(rng.standard_normal(jp["blocks"][n].shape) * 0.1,
                           jnp.float32) for n in ("bq", "bk", "bv")})
    tm = Model(get_config(arch, smoke=True), device="cpu")
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return arch, jm, jp, tm, tp


def _inputs(cfg, b, s, seed=2):
    """Numpy tokens and frontend features for a forward of ``s`` positions:
    the encoder takes ``s`` frames and no tokens, the vlm ``n_patches``
    patches and ``s - n_patches`` tokens."""
    rng = np.random.default_rng(seed)
    n_text = 0 if cfg.family == "encoder" else s - (
        cfg.n_patches if cfg.frontend == "vision" else 0)
    toks = rng.integers(0, cfg.vocab, (b, n_text)).astype(np.int32)
    feats = None
    if cfg.frontend:
        n_front = s if cfg.frontend == "audio" else cfg.n_patches
        feats = rng.standard_normal((b, n_front, cfg.frontend_dim)
                                    ).astype(np.float32)
    return toks, feats


def _j_feats(feats):
    return None if feats is None else jnp.asarray(feats, jnp.bfloat16)


def _t_feats(feats):
    return None if feats is None else torch.from_numpy(feats).to(
        torch.bfloat16)


def _tokens(cfg, b, s, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


def _logits_of(jcfg, jp, x):
    x = j_rms_norm(x, jp["final_norm"])
    return x @ (jp["embed"].T if jcfg.tie_embed else jp["lm_head"])


def _j_blocks(jp, layer):
    return jax.tree.map(lambda a: a[layer], jp["blocks"])


def _ref_moe(jcfg, x, blk):
    """The reference's MoE block (``_moe_fwd`` at rows = 1, no mesh), with
    the expert choices it makes; jitted by the caller."""
    b, s, d = x.shape
    xn = j_rms_norm(x, blk["ln2"]).reshape(b * s, d)
    _, ix = jmoe.route_topk(xn @ blk["router"], jcfg.top_k)
    y, aux = jmoe._routed_ffn(
        xn, blk["router"], blk["eg"], blk["eu"], blk["ed"], jcfg.top_k,
        jmoe.moe_capacity(b * s, jcfg.n_experts, jcfg.top_k,
                          jcfg.capacity_factor))
    if "sg" in blk:
        y = y + (jax.nn.silu(xn @ blk["sg"]) * (xn @ blk["su"])) @ blk["sd"]
    return x + y.astype(x.dtype).reshape(b, s, d), aux, ix


class _MoeReference:
    """The reference's MoE model evaluated one layer at a time (each
    layer's attention and MoE blocks jitted on their own), recording every
    MoE layer's expert choices in layer order (see the module docstring)."""

    def __init__(self, jcfg, jp):
        self.cfg, self.p = jcfg, jp
        self.moe = jax.jit(lambda x, b: _ref_moe(jcfg, x, b))

    def forward(self, toks):
        cfg, jp = self.cfg, self.p
        x = jp["embed"][jnp.asarray(toks)]
        sin, cos = j_rope(jnp.arange(x.shape[1]), cfg.hd, cfg.rope_theta)
        attn = jax.jit(lambda x, b: jtfm._attn_fwd(cfg, x, b, sin, cos))
        aux, ks, vs, choices = 0.0, [], [], []
        for layer in range(cfg.n_layers):
            blk = _j_blocks(jp, layer)
            x, (k, v) = attn(x, blk)
            x, a, ix = self.moe(x, blk)
            aux, choices = aux + a, choices + [np.array(ix)]
            ks.append(k)
            vs.append(v)
        return (_logits_of(cfg, jp, x), aux, (jnp.stack(ks), jnp.stack(vs)),
                choices)

    def decode_step(self, state, tok, pos):
        cfg, jp = self.cfg, self.p
        x = jp["embed"][jnp.asarray(tok)]
        sin, cos = j_rope(jnp.asarray([pos]), cfg.hd, cfg.rope_theta)
        attn = jax.jit(lambda x, b, kc, vc: jtfm._attn_decode(
            cfg, x, b, kc, vc, jnp.int32(pos), sin, cos))
        ks, vs, choices = [], [], []
        for layer in range(cfg.n_layers):
            blk = _j_blocks(jp, layer)
            x, kc, vc = attn(x, blk, state["k"][layer], state["v"][layer])
            x, _, ix = self.moe(x, blk)
            choices.append(np.array(ix))
            ks.append(kc)
            vs.append(vc)
        return (_logits_of(cfg, jp, x), {"k": jnp.stack(ks),
                                          "v": jnp.stack(vs)}, choices)


def _check_logits(got: torch.Tensor, want, what: str, cfg=None,
                  argmax: bool = True):
    """Logits within the family's tolerance of ``want``; with ``argmax``,
    argmax agreement on at least 90 % of the positions."""
    rtol, atol = FAMILY_TOL.get(cfg.family, (RTOL, ATOL)) if cfg else (
        RTOL, ATOL)
    g = got.to(torch.float32).numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, what
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)
    agree = (g.argmax(-1) == w.argmax(-1)).mean()
    assert not argmax or agree >= 0.9, f"{what}: argmax agreement {agree}"


def _check_state(got: dict, want: dict, cfg, what: str):
    rtol, atol = FAMILY_TOL.get(cfg.family, (RTOL, ATOL))
    assert sorted(got) == sorted(want), what
    for name in want:
        np.testing.assert_allclose(
            got[name].to(torch.float32).numpy(),
            np.asarray(want[name], np.float32), rtol=rtol, atol=atol,
            err_msg=f"{what} {name}")


def test_configs_registry_matches_reference():
    from repro.configs import ALL_ARCHS as J_ALL
    assert ALL_ARCHS == J_ALL
    for arch in ALL_ARCHS:
        for smoke in (False, True):
            assert (get_config(arch, smoke).__dict__
                    == j_get_config(arch, smoke).__dict__), (arch, smoke)


def test_forward_matches_reference(pair):
    arch, jm, jp, tm, tp = pair
    cfg = tm.cfg
    toks, feats = _inputs(cfg, B, S)
    replay = contextlib.nullcontext()
    if cfg.family == "moe":
        jl, jaux, jc, choices = _MoeReference(jm.cfg, jp).forward(toks)
        replay = tmoe.pinned_routing(replay=choices)
    else:
        jl, jaux, jc = jtfm.forward(jm.cfg, jp, jnp.asarray(toks),
                                    _j_feats(feats), return_cache=True)
    with replay:
        tl, taux, tc = ttfm.forward(cfg, tp, torch.from_numpy(toks),
                                    _t_feats(feats), return_cache=True)
    assert tl.dtype == torch.bfloat16 and taux.dtype == torch.float32
    _check_logits(tl, jl, f"{arch} forward", cfg)
    if cfg.family == "moe":
        assert float(taux) > 0
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)
    else:
        assert float(taux) == float(jaux) == 0.0
    assert (tc is None) == (jc is None) == (cfg.family == "ssm")
    if tc is None:
        return
    rtol, atol = FAMILY_TOL.get(cfg.family, (RTOL, ATOL))
    for got, want, name in zip(tc, jc, ("k", "v")):
        assert tuple(got.shape) == want.shape and got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(want, np.float32), rtol=rtol,
                                   atol=atol, err_msg=f"{arch} cache {name}")


def test_prefill_and_decode_sequence_match_reference(pair):
    """``prefill`` of 16 positions (text tokens; the stub features of the
    encoder and the vlm), then 32 ``decode_step``s fed the same tokens as
    the reference, each step from 16 on held to the reference's (argmax
    agreement over those steps), and the final decode states; the
    encoder's decode state raises in both."""
    arch, jm, jp, tm, tp = pair
    cfg = tm.cfg
    toks = _tokens(cfg, B, 32, seed=3)
    n_pre = 16 + (cfg.n_patches if cfg.frontend == "vision" else 0)
    ptoks, feats = _inputs(cfg, B, n_pre, seed=5)
    if cfg.family != "encoder":
        ptoks = toks[:, :16]
    ref = _MoeReference(jm.cfg, jp) if cfg.family == "moe" else None
    replay = contextlib.nullcontext()
    if ref:
        jl, _, _, choices = ref.forward(ptoks)
        jl, replay = jl[:, -1:], tmoe.pinned_routing(replay=choices)
    else:
        jl, _ = jm.prefill(jp, jnp.asarray(ptoks), _j_feats(feats))
    with replay:
        tl, caches = tm.prefill(tp, torch.from_numpy(ptoks), _t_feats(feats))
    assert tuple(tl.shape) == (B, 1, cfg.vocab)
    if caches is not None:
        n_attn = cfg.n_layers // 3 if cfg.family == "hybrid" else cfg.n_layers
        assert tuple(caches[0].shape) == (n_attn, B, n_pre, cfg.n_kv, cfg.hd)
    _check_logits(tl, jl, f"{arch} prefill", cfg)
    if not cfg.has_decode:
        for m in (jm, tm):
            with pytest.raises(ValueError, match="has no decode state"):
                m.init_decode_state(B, 32)
        return
    jst = jm.init_decode_state(B, 32)
    tst = tm.init_decode_state(B, 32)
    jdec = jax.jit(jm.decode_step)
    got, want = [], []
    for t in range(32):
        tok = toks[:, t:t + 1]
        replay = contextlib.nullcontext()
        if ref:
            jlg, jst, choices = ref.decode_step(jst, tok, t)
            replay = tmoe.pinned_routing(replay=choices)
        else:
            jlg, jst = jdec(jp, jst, jnp.asarray(tok), jnp.int32(t))
        with replay:
            tlg, tst = tm.decode_step(tp, tst, torch.from_numpy(tok), t)
        if t >= 16:
            _check_logits(tlg, jlg, f"{arch} decode step {t}", cfg,
                          argmax=cfg.family == "dense")
            got.append(tlg)
            want.append(np.asarray(jlg, np.float32))
    _check_logits(torch.cat(got, 1), np.concatenate(want, 1),
                  f"{arch} decode steps 16-31", cfg)
    _check_state(tst, jst, cfg, f"{arch} decode state")


def test_decode_matches_own_prefill(pair):
    """The port's decode path agrees with its own forward, as
    ``tests/test_archs_smoke.py`` checks the reference (the vlm's decode is
    the dense path over text, so its forward here takes no patches)."""
    arch, jm, jp, tm, tp = pair
    cfg = tm.cfg
    if not cfg.has_decode:      # both raise ValueError(family)
        with pytest.raises(ValueError, match="encoder"):
            jm.decode_step(jp, {}, jnp.zeros((B, 1), jnp.int32), jnp.int32(0))
        with pytest.raises(ValueError, match="encoder"):
            tm.decode_step(tp, {}, torch.zeros((B, 1), dtype=torch.int64), 0)
        return
    toks = _tokens(cfg, B, 8, seed=4)
    no_patches = None
    if cfg.frontend == "vision":
        no_patches = torch.zeros((B, 0, cfg.frontend_dim),
                                 dtype=torch.bfloat16)
    full, _, _ = ttfm.forward(cfg, tp, torch.from_numpy(toks), no_patches)
    st = tm.init_decode_state(B, 8)
    outs = []
    for t in range(8):
        lg, st = tm.decode_step(tp, st, torch.from_numpy(toks[:, t:t + 1]), t)
        outs.append(lg[:, 0])
    _check_logits(torch.stack(outs, 1), full.to(torch.float32).numpy(),
                  f"{arch} decode vs prefill", cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_decode_state_shapes_match_reference(arch):
    jm = JModel(j_get_config(arch, smoke=True))
    tm = Model(get_config(arch, smoke=True), device="cpu")
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                           unbox(jm.init_abstract()))
    tp = tm.init(torch.Generator().manual_seed(0))
    tshapes = jax.tree.map(lambda t: (tuple(t.shape),
                                      str(t.dtype).removeprefix("torch.")),
                           tp)
    assert tshapes == jshapes
    assert sum(t.numel() for t in jax.tree.leaves(tp)) == jm.n_params()
    # the port's init is seeded: same generator seed, same weights
    again = tm.init(torch.Generator().manual_seed(0))
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tp)):
        assert torch.equal(a, b)
    if not tm.cfg.has_decode:
        for m in (jm, tm):
            with pytest.raises(ValueError, match="has no decode state"):
                m.init_decode_state(3, 20)
        return
    js = jm.init_decode_state(3, 20)
    ts = tm.init_decode_state(3, 20)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert tuple(ts[k].shape) == js[k].shape
        assert str(ts[k].dtype).removeprefix("torch.") == str(js[k].dtype)
        assert not ts[k].any()


def test_params_round_trip_keeps_bits():
    jm = JModel(j_get_config("qwen3-0.6b", smoke=True))
    np_tree = jax.tree.map(np.asarray, unbox(jm.init(jax.random.key(5))))
    back = interop.params_to_numpy(interop.params_from_numpy(np_tree, "cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(np_tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert b.dtype == (np.float32 if a.dtype == jnp.bfloat16 else a.dtype)
        assert b.shape == a.shape
        assert np.array_equal(b.astype(a.dtype).view(np.uint8),
                              a.view(np.uint8)), path


@pytest.mark.parametrize("arch", ARCHS)
def test_model_defaults_to_cuda(arch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(get_config(arch, smoke=True))
